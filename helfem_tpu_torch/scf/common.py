"""Helpers shared by the atomic and diatomic SCF drivers: aufbau occupations
over symmetry blocks, the block-coordinate DIIS error, the full-matrix
whitening from its blocks and the crash-recovery hook's call."""

import numpy as np
import torch

from helfem_tpu_torch.utils.linalg import _BIG, build_blocks

__all__ = ["aufbau_blocks", "diis_error_blocks", "full_sinvh", "hook_state",
           "occ_fixed_blocks", "symmetric_sinvh", "vdot", "warm_gate"]


def aufbau_blocks(E: np.ndarray, nel: float) -> np.ndarray:
    """Occupations [nblk, blen] over globally sorted block eigenvalues with
    degeneracy averaging (keeps open shells spherical / pi_+- symmetric)."""
    nblk, blen = E.shape
    occ = np.zeros(nblk * blen)
    flat = E.ravel()
    order = np.argsort(flat, kind="stable")
    left = float(nel)
    i = 0
    while left > 1e-12 and i < len(order):
        if flat[order[i]] > _BIG / 2:
            break
        j = i
        while j + 1 < len(order) and flat[order[j + 1]] - flat[order[i]] < 1e-8:
            j += 1
        ndeg = j - i + 1
        fill = min(left, float(ndeg))
        for k in range(i, j + 1):
            occ[order[k]] = fill / ndeg
        left -= fill
        i = j + 1
    if left > 1e-12:
        raise ValueError(
            f"aufbau could not place {left:g} electrons: only "
            f"{int((flat < _BIG / 2).sum())} usable eigenvalues"
        )
    return occ.reshape(nblk, blen)


def occ_fixed_blocks(E: np.ndarray, nocc) -> np.ndarray:
    """Occupations with a FIXED electron count per symmetry block (the
    reference's --readocc): aufbau within each block on its own
    (helfem_tpu diatomic_scf.py:308-315)."""
    occ = np.zeros(E.shape)
    for b in range(E.shape[0]):
        occ[b] = aufbau_blocks(E[b:b + 1], float(nocc[b]))[0]
    return occ


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def diis_error_blocks(Fb, Pb, Sb, blk_sinvh):
    """DIIS error Sinvh^T ([F,P]S-commutator) Sinvh per SYMMETRY BLOCK, from
    block-coordinate matrices [nblk, blen, blen]: the reference's error
    metric under --symmetry (helfem_tpu atomic_scf.py:133-145)."""
    FPS = Fb @ Pb @ Sb
    M = FPS - FPS.transpose(1, 2)
    return (blk_sinvh.mT @ M @ blk_sinvh).reshape(-1)


def full_sinvh(blk_idx: np.ndarray, blk_sinvh: np.ndarray, nbf: int) -> np.ndarray:
    """The [nbf, nbf] whitening matrix assembled from its symmetry blocks
    (blk_idx pads with the trash index nbf)."""
    out = np.zeros((nbf + 1, nbf + 1))
    for b in range(blk_idx.shape[0]):
        idx = blk_idx[b]
        out[np.ix_(idx, idx)] += blk_sinvh[b]
    return out[:nbf, :nbf]


def symmetric_sinvh(S: np.ndarray, blk_idx: np.ndarray) -> np.ndarray:
    """The [nbf, nbf] symmetric inverse square root of S over the blocks of
    blk_idx (padded with nbf), whatever whitening the SCF's blocks use:
    rohf_update's natural orbitals need it (under --diag 0 too)."""
    nbf = S.shape[0]
    return full_sinvh(*build_blocks(S, [row[row < nbf] for row in blk_idx]), nbf)


def hook_state(save_cb, it: int, Etot: float, restricted: bool, Ea, Ca: torch.Tensor, occa,
               Eb, Cb: torch.Tensor, occb) -> None:
    """Call the crash-recovery hook save_cb(it, Etot, Ea, Ca, occa, Eb, Cb,
    occb) with host numpy arrays, the beta ones None when restricted
    (helfem_tpu's call): one card-to-host copy of the orbitals per spin."""
    if restricted:
        save_cb(it, Etot, Ea, Ca.cpu().numpy(), occa, None, None, None)
    else:
        save_cb(it, Etot, Ea, Ca.cpu().numpy(), occa, Eb, Cb.cpu().numpy(), occb)


def warm_gate(convthr: float) -> float:
    """The certificate gate of the fused chunks' warm eigensolve, well below
    their convergence gate: min(0.1 convthr, 1e-9), as helfem_tpu's atomic,
    diatomic and SAD chunks take it (atomic_scf.py:285, diatomic_scf.py:423,
    sadatom.py:891)."""
    return min(0.1 * convthr, 1e-9)
