"""The math the erfc exchange kernel K10 relies on, on the CPU: the erfc
tables' three symmetries, the packed copy of their unique entries
(pack_erfc_table) and its inverse, and a plain emulation of the kernel's
contraction (each slab e <= f once, against the windows of Pd and of Pd^T,
the second set written transposed into Kp[f, e]) against
radial_erfc_exchange_plain. helfem_tpu's erfc_exchange on symmetry 0
windows is held against the port's in tests/test_torch_fields.py
(test_dense_exchange_matches_jax[erfc]). Beside them, an emulation of the
kernel's split of the work into tasks and items (column parts, row parts,
the cross items of a diagonal slab split in rows) that checks each output
entry is written once and the result matches the plain version."""

import importlib
import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu_torch.kernels import radial_erfc_exchange_plain
from helfem_tpu_torch.models.atomic import AtomicBasis

BASIS = dict(lmax=0, mmax=0, rmax=15.0, nelem=5, nnodes=8, nquad=40)  # tests/test_torch_rs.py's
OMEGA = 0.5
k10 = importlib.import_module("helfem_tpu_torch.kernels.radial_erfc_exchange")  # the module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread and one BLAS thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def be():
    """Be at BASIS with lmax 1 (NL 3): its erfc tables and gidx."""
    basis = AtomicBasis(Z=4, **dict(BASIS, lmax=1))
    tei = torch.tensor(basis.host_erfc(OMEGA)["tei"])
    return basis, tei, torch.tensor(basis.rb.fem.gidx, dtype=torch.int32)


def _symmetrised(rng, NL, nelem, npr):
    """A random table with the erfc tables' three symmetries."""
    T = rng.standard_normal((NL, nelem, nelem) + (npr,) * 4)
    T = T + T.transpose(0, 1, 2, 4, 3, 5, 6)
    T = T + T.transpose(0, 1, 2, 3, 4, 6, 5)
    return torch.tensor(T + T.transpose(0, 2, 1, 5, 6, 3, 4))


def _fem_gidx(nelem, nnodes, primbas=4):
    from helfem_tpu_torch.ops.fem import FEMBasis
    from helfem_tpu_torch.ops.polynomials import get_basis

    fem = FEMBasis(get_basis(primbas, nnodes), np.linspace(0.0, 10.0, nelem + 1))
    return torch.tensor(fem.gidx, dtype=torch.int32), fem.nbf


def _channels(rng, n, nrad, symmetric):
    X = rng.standard_normal((n, nrad, nrad))
    return torch.tensor(X + X.transpose(0, 2, 1) if symmetric else X)


def _rows(npr):
    """The slab row (or entry) of every flat (i, j), as the kernel indexes it."""
    i, j = np.divmod(np.arange(npr * npr), npr)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    return torch.tensor(lo * npr - lo * (lo - 1) // 2 + hi - lo)


def _slabs(packed, nelem, npr):
    """(g, e, f, T) of every slab of the packed table in its order: T[i, j,
    k, l] from M (for e = f its upper triangle, diagonal halved)."""
    nr = npr * (npr + 1) // 2
    rows = _rows(npr)
    ru = torch.triu_indices(nr, nr)
    pairs = [(e, f) for e in range(nelem) for f in range(e + 1, nelem)]
    pairs += [(e, e) for e in range(nelem)]
    for g in range(packed.shape[0]):
        at = 0
        for e, f in pairs:
            if e != f:
                M = packed[g, at:at + nr * nr].reshape(nr, nr)
                at += nr * nr
            else:
                M = torch.zeros((nr, nr), dtype=packed.dtype)
                M[ru[0], ru[1]] = packed[g, at:at + len(ru[0])]
                M.diagonal().mul_(0.5)
                at += len(ru[0])
            yield g, e, f, M[rows][:, rows].reshape((npr,) * 4)
        assert at == packed.shape[1]


def _windows(Pd, gidx, e, f):
    """W[a, i, l] = Pd[a][gidx[e, i], gidx[f, l]] and What[a, i, l] =
    Pd[a][gidx[f, l], gidx[e, i]], the trash slot read as 0."""
    Pp = torch.nn.functional.pad(Pd, (0, 1, 0, 1))
    g_ = gidx.long()
    return Pp[:, g_[e][:, None], g_[f][None, :]], Pp[:, g_[f][None, :], g_[e][:, None]]


def _assemble(Kp, gidx, nrad):
    """KK[g, a] from Kp[g, a, e, j, f, k] over gidx (the trash slot dropped)."""
    NL, nang, nelem, npr = Kp.shape[:4]
    out = torch.zeros((NL, nang, nrad + 1, nrad + 1), dtype=Kp.dtype)
    g_ = gidx.long()
    for e in range(nelem):
        for f in range(nelem):
            out[:, :, g_[e][:, None], g_[f][None, :]] += Kp[:, :, e, :, f, :]
    return out[:, :, :nrad, :nrad]


def packed_contraction(packed, nelem, npr, gidx, Pd):
    """The kernel's contraction in plain PyTorch: per g and element pair e
    <= f, the slab M from the packed table, C_M(W) into Kp[e, f] and
    C_M(What)^T into Kp[f, e] (for e = f both into Kp[e, e]); then the
    assembly over gidx."""
    NL, nang, nrad = packed.shape[0], Pd.shape[0], Pd.shape[1]
    Kp = torch.zeros((NL, nang, nelem, npr, nelem, npr), dtype=Pd.dtype)
    for g, e, f, T in _slabs(packed, nelem, npr):
        W, What = _windows(Pd, gidx, e, f)
        Kp[g, :, e, :, f, :] += torch.einsum("ijkl,ail->ajk", T, W)
        Kp[g, :, f, :, e, :] += torch.einsum("ijkl,ail->ajk", T, What).transpose(1, 2)
    return _assemble(Kp, gidx, nrad)


def kernel_tasks(packed, nelem, npr, gidx, Pd, p):
    """The kernel's split of the work as csrc/radial_erfc_exchange.cu does
    it for the plan p (MT, NG, CPP, JP): tasks (column part, row part, g,
    pair), each task's items (re_item_at: the part's rows at every m-group;
    on a diagonal slab split in rows also every other row at the m-groups of
    the part's rows) writing their sums O[col][j, k] (W and What columns
    interleaved), then the task's output loop. Asserts that no item or
    output entry is written twice and that the output loop reads only sums
    its items wrote; returns KK."""
    NL, nang, nrad = packed.shape[0], Pd.shape[0], Pd.shape[1]
    MT, NG, CPP, JP = p.MT, p.NG, p.CPP, p.JP
    ncol, gm = 2 * nang, 8 * MT
    ngrp = math.ceil(math.ceil(ncol / 8) / NG)
    nmg, nrp = math.ceil(npr / gm), math.ceil(npr / JP)
    Kp = torch.full((NL, nang, nelem, npr, nelem, npr), math.nan, dtype=Pd.dtype)
    for g, e, f, T in _slabs(packed, nelem, npr):
        W, What = _windows(Pd, gidx, e, f)
        cols = torch.stack([W, What], 1).reshape(ncol, npr, npr)  # column 2a: W_a, 2a + 1: What_a
        full = torch.einsum("ijkl,cil->cjk", T, cols)
        diag = e == f
        for part in range(math.ceil(ngrp / CPP) * nrp):
            cp, rp = divmod(part, nrp)
            c0, ncl = 8 * NG * CPP * cp, min(ncol - 8 * NG * CPP * cp, 8 * NG * CPP)
            ncg, j0 = min(CPP, ngrp - CPP * cp), rp * JP
            nj = min(JP, npr - j0)
            nmgp = math.ceil(nj / gm)
            band = nj * nmg
            per = band + ((npr - nj) * nmgp if diag and nrp > 1 else 0)
            assert ncg * per <= 8 * min(16, 32 // (MT * NG))  # the registers hold them
            O = torch.full((ncol, npr, npr), math.nan, dtype=Pd.dtype)
            for x in range(ncg * per):
                lg, y = divmod(x, per)
                if y < band:
                    j, mg = j0 + y // nmg, y % nmg
                else:
                    j, mg = divmod(y - band, nmgp)
                    j, mg = j + (nj if j >= j0 else 0), j0 // gm + mg
                k = slice(gm * mg, min(npr, gm * (mg + 1)))
                c = slice(c0 + 8 * NG * lg, min(c0 + ncl, c0 + 8 * NG * (lg + 1)))
                assert torch.isnan(O[c, j, k]).all()
                O[c, j, k] = full[c, j, k]
            for ch in range(ncl // 2):
                a, C, Chat = (c0 + 2 * ch) // 2, O[c0 + 2 * ch], O[c0 + 2 * ch + 1]
                rows = slice(j0, j0 + nj)
                out = [(e, f, rows, slice(None), C[rows] + (Chat[:, rows].T if diag else 0))]
                if not diag:
                    out.append((f, e, slice(None), rows, Chat[rows].T))
                for ee, ff, r, s, v in out:
                    assert torch.isnan(Kp[g, a, ee, r, ff, s]).all() and not torch.isnan(v).any()
                    Kp[g, a, ee, r, ff, s] = v
    assert not torch.isnan(Kp).any()
    return _assemble(Kp, gidx, nrad)


@pytest.mark.parametrize("sym", ["i<->j", "k<->l", "pair swap"])
def test_erfc_tables_have_the_three_symmetries(be, sym):
    """host_erfc's table is symmetric under i <-> j, k <-> l and the pair
    swap (e,i,j) <-> (f,k,l), within 1e-14 of its max-abs."""
    _, tei, _ = be
    other = {"i<->j": tei.transpose(3, 4), "k<->l": tei.transpose(5, 6),
             "pair swap": tei.permute(0, 2, 1, 5, 6, 3, 4)}[sym]
    assert float((tei - other).abs().max()) <= 1e-14 * float(tei.abs().max())


def test_pack_then_unpack_gives_back_the_table(be):
    """Every kept entry comes back bit for bit, its partners within 1e-14 of
    the max-abs; the packed copy holds the unique entries and no more."""
    basis, tei, _ = be
    NL, nelem, npr = tei.shape[0], tei.shape[1], tei.shape[3]
    packed = k10.pack_erfc_table(tei)
    nr = npr * (npr + 1) // 2
    assert packed.shape == (NL, nelem * (nelem - 1) // 2 * nr * nr + nelem * nr * (nr + 1) // 2)
    back = k10.unpack_erfc_table(packed, nelem, npr)
    assert back.shape == tei.shape
    assert float((back - tei).abs().max()) <= 1e-14 * float(tei.abs().max())
    # the kept entries: e <= f, i <= j, k <= l and r <= s on e = f
    rows = _rows(npr)
    i, j = np.divmod(np.arange(npr * npr), npr)
    keep_ij = torch.tensor(i <= j)
    T = tei.reshape(NL, nelem, nelem, npr * npr, npr * npr)
    B = back.reshape(T.shape)
    for e in range(nelem):
        for f in range(e, nelem):
            mask = keep_ij[:, None] & keep_ij[None, :]
            if e == f:
                mask &= rows[:, None] <= rows[None, :]
            assert torch.equal(B[:, e, f][:, mask], T[:, e, f][:, mask])


def test_packed_bytes_at_the_bench_bases():
    """The unique entries: 16.5 MiB of 115.9 at the Ar bench basis (NL 3,
    nelem 10, nprim 15), 10.4 of 70.9 at Xe (NL 7, nelem 8, nprim 12)."""
    for NL, nelem, npr, mib, full in ((3, 10, 15, 16.5, 115.9), (7, 8, 12, 10.4, 70.9)):
        npk = npr * (npr + 1) // 2
        unique = NL * (nelem * (nelem - 1) // 2 * npk**2 + nelem * npk * (npk + 1) // 2)
        assert round(8 * unique / 2**20, 1) == mib
        assert round(8 * NL * nelem**2 * npr**4 / 2**20, 1) == full


CASES = {  # (symmetric channels, nelem, nnodes): the Be tables, or random symmetric ones
    "symmetric channels": (True, None, None),
    "non-symmetric windows": (False, None, None),
    "nelem 1": (False, 1, 8),
    "odd nprim": (True, 3, 7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_packed_contraction_matches_plain(be, case):
    """The emulation of the kernel's contraction on the packed table
    matches radial_erfc_exchange_plain within 1e-13 of the max-abs."""
    symmetric, nelem, nnodes = CASES[case]
    rng = np.random.default_rng(29)
    if nelem is None:
        basis, tei, gidx = be
        nrad = basis.nrad
    else:
        gidx, nrad = _fem_gidx(nelem, nnodes)
        tei = _symmetrised(rng, 2, nelem, gidx.shape[1])
    Pd = _channels(rng, 3, nrad, symmetric)
    npr = gidx.shape[1]
    got = packed_contraction(k10.pack_erfc_table(tei), tei.shape[1], npr, gidx, Pd)
    ref = radial_erfc_exchange_plain(tei, gidx, Pd)
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def test_asymmetric_table_is_refused():
    """The wrapper's check: a table without the symmetries raises, naming
    the one it lacks."""
    rng = np.random.default_rng(31)
    tei = _symmetrised(rng, 1, 2, 4)
    k10.check_symmetric("radial_erfc_exchange", tei)
    bad = tei.clone()
    bad[0, 0, 1, 0, 1, 2, 3] += 1e-6
    with pytest.raises(ValueError, match="symmetric"):
        k10.check_symmetric("radial_erfc_exchange", bad)


@pytest.mark.parametrize("shape, want", [
    # (NL, nang, nelem, nprim, nrad): (MT, NG, CPP)
    ((3, 4, 10, 15, 139), (2, 4, 1)),  # Ar bench, one spin
    ((3, 8, 10, 15, 139), (2, 4, 1)),  # two spins
    ((7, 32, 8, 12, 87), (2, 4, 2)),  # Xe bench, two spins: 64 columns
    ((5, 49, 6, 8, 41), (1, 8, 2)),  # Ne lmax=2 symmetry 0: 98 columns, 16 items
    ((3, 4, 1, 8, 6), (1, 8, 1)),  # nelem 1
])
def test_plan_holds_every_column_in_one_part(shape, want):
    """The tile plan of the shapes the card runs: every column against one
    resident slab (one part), within a block's shared memory, four stages."""
    p = k10.plan(*shape)
    assert (p.MT, p.NG, p.CPP) == want
    NL, nang, nelem = shape[:3]
    assert p.tasks == NL * nelem * (nelem + 1) // 2
    assert p.smem <= k10.SMEM_BLOCK and p.NS == 4 and p.STG >= p.RC


@pytest.mark.parametrize("shape, want", [
    # (NL, nang, nelem, nprim, nrad): (MT, NG, CPP, JP)
    ((3, 12, 3, 21, 61), (1, 4, 1, 21)),  # run-time depth, NG 4: 63 items
    ((3, 4, 3, 22, 64), (1, 1, 1, 22)),  # HIP (primbas 5) on 11 nodes, one spin
    ((3, 8, 3, 22, 64), (1, 1, 1, 22)),  # two spins: two column parts
    ((3, 17, 3, 40, 118), (1, 1, 1, 16)),  # rows in parts of 16
    ((1, 4, 2, 48, 95), (1, 1, 1, 8)),  # rows in parts of 8
    ((3, 4, 3, 52, 150), (1, 1, 1, 8)),  # the largest nprim that fits
])
def test_plan_takes_nprim_above_20(shape, want):
    """Past nprim 20 the kernel's run-time depth instance takes the shape,
    with the rows split in parts where an output row's items outgrow the
    registers; every part's items fit (re_sizes: maxitem)."""
    p = k10.plan(*shape)
    assert (p.MT, p.NG, p.CPP, p.JP) == want
    NL, nang, nelem, npr = shape[:4]
    nmg = math.ceil(npr / 8)
    cross = p.JP * nmg + (npr - p.JP) * math.ceil(p.JP / 8) if p.JP < npr else npr * nmg
    assert p.CPP * cross <= 8 * min(16, 32 // p.NG)
    ngrp = math.ceil(math.ceil(2 * nang / 8) / p.NG)
    assert p.tasks == math.ceil(ngrp / p.CPP) * math.ceil(npr / p.JP) * NL * nelem * (nelem + 1) // 2
    assert p.smem <= k10.SMEM_BLOCK


def test_plan_refuses_what_does_not_fit():
    """Past nprim 52 the windows of one column group outgrow a block's
    shared memory: the plan says so, naming the shape."""
    with pytest.raises(ValueError, match="nprim=56 with 4 channels"):
        k10.plan(3, 4, 3, 56, 160)


TASK_CASES = {  # (nelem, nnodes, nang, plan fields MT, NG, CPP, JP): small shapes, forced splits
    "the plan at nprim 9": (3, 9, 3, None),
    "rows in parts of 8": (3, 12, 3, (1, 1, 1, 8)),
    "rows and columns in parts": (2, 13, 7, (1, 1, 1, 8)),
    "nelem 1 in row parts": (1, 20, 2, (1, 4, 1, 8)),
    "odd nprim in row parts": (2, 15, 5, (1, 4, 1, 8)),
}


@pytest.mark.parametrize("case", list(TASK_CASES))
def test_kernel_task_split_matches_plain(case):
    """The kernel's tasks and items (kernel_tasks) on non-symmetric windows
    write each output entry once and match radial_erfc_exchange_plain
    within 1e-13 of the max-abs."""
    nelem, nnodes, nang, fields = TASK_CASES[case]
    rng = np.random.default_rng(37)
    gidx, nrad = _fem_gidx(nelem, nnodes)
    npr = gidx.shape[1]
    tei = _symmetrised(rng, 2, nelem, npr)
    Pd = _channels(rng, nang, nrad, False)
    p = k10.plan(2, nang, nelem, npr, nrad)
    if fields is not None:
        p = p._replace(**dict(zip(("MT", "NG", "CPP", "JP"), fields)))
    got = kernel_tasks(k10.pack_erfc_table(tei), nelem, npr, gidx, Pd, p)
    ref = radial_erfc_exchange_plain(tei, gidx, Pd)
    assert float((got - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def test_split_tool_variants_still_apply():
    """tools/erfc_split.py edits the kernel's source by anchors: each is
    still there."""
    from pathlib import Path

    from helfem_tpu_torch.tools import erfc_split

    src = (Path(k10.__file__).parents[1] / "csrc" / erfc_split.SOURCE).read_text()
    for name, edits in erfc_split.VARIANTS.items():
        for old, _ in edits:
            assert old in src, (name, old)
