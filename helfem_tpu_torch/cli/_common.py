"""Helpers shared by the port's CLIs: electron counts, the rejection of
flags of the JAX CLIs that the port does not cover, and the device."""

__all__ = ["open_device", "parse_nela_nelb", "reject_unported"]


def parse_nela_nelb(Z: int, Q: int, M: int, nela: int, nelb: int):
    """(reference: scf::parse_nela_nelb)."""
    if nela or nelb:
        return nela, nelb
    nel = Z - Q
    if M == 0:
        M = 1 if nel % 2 == 0 else 2
    na = (nel + M - 1) // 2
    return na, nel - na


def reject_unported(extra: list[str], unported: tuple, prog: str) -> None:
    """Raise NotImplementedError for a flag of the JAX CLI in `unported`,
    and exit for any other unknown argument."""
    for arg in extra:
        name = arg[2:].split("=", 1)[0] if arg.startswith("--") else ""
        if name in unported:
            raise NotImplementedError(
                f"--{name} is not ported to helfem_tpu_torch yet (see ROADMAP.md)"
            )
    if extra:
        raise SystemExit(f"{prog}: unrecognized arguments: {' '.join(extra)}")


def open_device(name: str):
    """The torch device of --device; raises for cuda when no card is
    present (nothing falls back to the CPU)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device
