"""K11 refine_eig: the refinement sweeps of the warm-started eigensolve, with
their residual certificate, as a hand-written CUDA kernel
(csrc/refine_eig.cu) and its plain PyTorch version.

Replaces no Pallas kernel: helfem_tpu runs these sweeps as the lax.scan of
helfem_tpu/utils/linalg.py:_refine_passes (:21-47) inside the XLA program of
eigh_warm_with (:134-140). Given symmetric A [B, n, n] and approximate
eigenvectors V0 [B, n, n] (f64), npass + 1 sweeps of

    M = V^T A V;  E = diag(M);  off = max |M - diag(E)|
    C_ij = clip(M_ij / (E_j - E_i), -0.1, 0.1), 0 where |E_j - E_i| <=
           tau (max(|E_i|, |E_j|) + 1)
    V <- V + V C;  V <- V (1.5 I - 0.5 V^T V)

give (E, V, off): the last sweep's E and off, taken before its update of V,
and the updated V, unsorted. off [groups] is the maximum over each group of
B / groups consecutive blocks: one certificate per spin when the spins'
blocks are stacked. helfem_tpu's first product V0^T A V0 (linalg.py:138) is
overwritten by the first sweep before it is read, so neither version forms
it.
"""

import torch

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import check_kernel_inputs, expect_shape, launches, on_cpu

__all__ = ["refine_eig", "refine_eig_plain", "refine_sweeps"]


def refine_sweeps(A: torch.Tensor, V: torch.Tensor, nsweep: int, tau: float = 1e-9,
                  groups: int = 1):
    """nsweep >= 1 plain sweeps over the leading axes of A and V (the body
    of helfem_tpu's _refine_passes); returns (E, V, off), off [groups] from
    the last sweep (None for groups=0). Shared by refine_eig_plain and
    utils/linalg.py:eigh_refined."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    E = off = None
    for s in range(nsweep):
        M = V.mT @ A @ V
        E = torch.diagonal(M, dim1=-2, dim2=-1)
        if groups and s == nsweep - 1:
            off = (M - E[..., None] * eye).abs().reshape(groups, -1).amax(dim=1)
        dE = E[..., None, :] - E[..., :, None]
        scale = torch.maximum(E.abs()[..., None, :], E.abs()[..., :, None]) + 1.0
        mask = dE.abs() > tau * scale
        C = torch.where(mask, M / torch.where(mask, dE, torch.ones_like(dE)),
                        torch.zeros_like(M)).clamp(-0.1, 0.1)
        V = V + V @ C
        V = V @ (1.5 * eye - 0.5 * (V.mT @ V))
    return E, V, off


def refine_eig_plain(A: torch.Tensor, V0: torch.Tensor, npass: int = 3, tau: float = 1e-9,
                     groups: int = 1):
    """Plain PyTorch version of refine_eig: npass + 1 sweeps."""
    _check(A, V0, npass, groups)
    return refine_sweeps(A, V0, npass + 1, tau, groups)


def _check(A, V0, npass, groups) -> None:
    name = "refine_eig"
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[0] < 1 or A.shape[1] < 1:
        raise ValueError(f"{name}: A must be a batch of square matrices [B, n, n], "
                         f"got {tuple(A.shape)}")
    expect_shape(name, "V0", V0, A.shape)
    if npass < 0:
        raise ValueError(f"{name}: npass must be >= 0, got {npass}")
    if groups < 1 or A.shape[0] % groups:
        raise ValueError(f"{name}: {A.shape[0]} blocks do not split into {groups} groups")


def refine_eig(A: torch.Tensor, V0: torch.Tensor, npass: int = 3, tau: float = 1e-9,
               groups: int = 1):
    """(E [B, n], V [B, n, n], off [groups]) of npass + 1 refinement sweeps
    of the symmetric A [B, n, n] from V0 [B, n, n] (module docstring). CPU
    inputs run the plain version; CUDA inputs (f64, contiguous) launch the
    kernel, one cooperative launch per call, or raise."""
    name = "refine_eig"
    _check(A, V0, npass, groups)
    if on_cpu(name, A, V0):
        return refine_eig_plain(A, V0, npass, tau, groups)
    check_kernel_inputs(name, {"A": A, "V0": V0}, {})
    if groups > 256:  # the kernel zeroes one certificate per thread of a block
        raise ValueError(f"{name}: at most 256 groups, got {groups}")
    B, n = A.shape[0], A.shape[1]
    npad = -(-n // 8) * 8
    dev = A.device
    V = torch.empty_like(A)
    E = torch.empty((B, n), dtype=A.dtype, device=dev)
    off = torch.empty(groups, dtype=A.dtype, device=dev)
    # four padded matrices and the padded E (csrc/refine_eig.cu)
    scratch = torch.empty(4 * B * npad * npad + B * npad, dtype=A.dtype, device=dev)
    err = _build.lib().refine_eig_launch(
        *(t.data_ptr() for t in (A, V0, V, E, off, scratch)),
        B, n, npass + 1, groups, dev.index, float(tau),
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return E, V, off
