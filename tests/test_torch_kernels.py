"""The port's radial kernels: plain versions against an independent
element-pair reference on the CPU, and (marked `cuda`) the CUDA kernels
against the plain versions on the card.

This file imports no JAX, so the card tests also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from helfem_tpu_torch import kernels
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.kernels.matmul_probe import split_dd
from helfem_tpu_torch.models.diatomic import (
    DiatomicBasis, _to4, exchange_factors, exchange_weights,
)
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

TOL = 1e-12
CONFIGS = {
    "ne_np8": dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=4, nnodes=8),
    "kr_np5": dict(Z=36, lmax=2, mmax=2, rmax=30.0, nelem=6, nnodes=5),
    "he_np15": dict(Z=2, lmax=0, mmax=0, rmax=20.0, nelem=3, nnodes=15),
    # NM = 17 Coulomb (L, M) helpers: 2*NM traces exceed the 32-thread block
    "ar_l4_np5": dict(Z=18, lmax=4, mmax=4, rmax=30.0, nelem=4, nnodes=5),
    # --zeroder on a Hermite basis: the last element holds two trash slots
    "ne_hip_zeroder": dict(Z=10, lmax=1, mmax=1, rmax=30.0, nelem=4, nnodes=4, primbas=5,
                           zeroder=True),
}


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def host(request):
    basis = AtomicBasis(**CONFIGS[request.param])
    return basis, basis.host_operators()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _inputs(basis, ops, dev, seed=41):
    X = np.random.default_rng(seed).standard_normal((basis.nang, basis.nrad, basis.nrad))
    Pd = torch.tensor(X + X.transpose(0, 2, 1), device=dev)
    t = {k: torch.tensor(v, device=dev) for k, v in ops.items() if k != "gidx"}
    gidx = torch.tensor(ops["gidx"], dtype=torch.int32, device=dev)
    Paux = torch.einsum("LMaa,aIJ->LMIJ", t["G"], Pd).contiguous()
    return {
        "radial_exchange": (t["tei"], t["disjL"], t["disjm1L"], gidx, Pd),
        "radial_coulomb": (Paux, t["tei"], t["disjL"], t["disjm1L"], t["Lfac"], gidx),
    }


def _wrapper_module(name):
    """The module kernels/<name>.py (the package attribute of that name is
    its wrapper function)."""
    return importlib.import_module(f"helfem_tpu_torch.kernels.{name}")


def _windows(M, gidx, nrad):
    """W[e, f] = M[gidx[e], gidx[f]] with the trash slot read as zero."""
    Mp = np.pad(M, ((0, 1), (0, 1)))
    return Mp[gidx[:, None, :, None], gidx[None, :, None, :]]


def _assemble(Kpair, gidx, nrad):
    out = np.zeros((nrad + 1, nrad + 1))
    ne = gidx.shape[0]
    for e in range(ne):
        for f in range(ne):
            out[np.ix_(gidx[e], gidx[f])] += Kpair[e, f]
    return out[:nrad, :nrad]


def _close_blocks(got, ref):
    """Each [nrad, nrad] block within TOL x its max-abs."""
    for g in range(ref.shape[0]):
        for a in range(ref.shape[1]):
            assert np.abs(got[g, a] - ref[g, a]).max() <= TOL * np.abs(ref[g, a]).max()


def _exchange_pair_reference(args, nrad):
    """K1's function by element-pair loops (the reference's
    TwoDBasis.cpp:987-1135 layout), [NL, nang, nrad, nrad]."""
    tei, U, V, gidx, Pd = (a.numpy() for a in args)
    ne = gidx.shape[0]
    out = np.zeros((tei.shape[0], Pd.shape[0], nrad, nrad))
    for g in range(tei.shape[0]):
        for a in range(Pd.shape[0]):
            W = _windows(Pd[a], gidx, nrad)
            Kp = np.zeros(W.shape)
            for e in range(ne):
                for f in range(ne):
                    if e == f:
                        Kp[e, e] = np.einsum("ijkl,il->jk", tei[g, e], W[e, e])
                    elif e > f:
                        Kp[e, f] = V[g, e] @ W[e, f] @ U[g, f].T
                    else:
                        Kp[e, f] = U[g, e] @ W[e, f] @ V[g, f].T
            out[g, a] = _assemble(Kp, gidx, nrad)
    return out


def test_plain_pairwise_exchange_matches_element_pair_reference(host):
    """The pairwise plain form (the Yukawa tables' yardstick) on the same
    loops."""
    basis, ops = host
    args = _inputs(basis, ops, "cpu")["radial_exchange"]
    _close_blocks(kernels.radial_exchange_pairwise_plain(*args).numpy(),
                  _exchange_pair_reference(args, basis.nrad))


def _random_erfc_inputs(dev, nnodes, ns, nelem=3, NL=3, nang=4, seed=61, primbas=4):
    """K10's inputs on random tables: the element layout of an FEMBasis of
    nelem elements of primbas (LIP by default) on nnodes nodes, random tei
    [NL, nelem, nelem, np^4] with the erfc tables' symmetries (i <-> j,
    k <-> l, the pair swap), which the kernel's packed copy relies on, and
    ns * nang random symmetric channels."""
    from helfem_tpu_torch.ops.fem import FEMBasis
    from helfem_tpu_torch.ops.polynomials import get_basis

    fem = FEMBasis(get_basis(primbas, nnodes), np.linspace(0.0, 10.0, nelem + 1))
    rng = np.random.default_rng(seed)
    npr, nrad = fem.nprim, fem.nbf
    T = rng.standard_normal((NL, nelem, nelem) + (npr,) * 4)
    T = T + T.transpose(0, 1, 2, 4, 3, 5, 6)
    T = T + T.transpose(0, 1, 2, 3, 4, 6, 5)
    tei = torch.tensor(T + T.transpose(0, 2, 1, 5, 6, 3, 4), device=dev)
    X = rng.standard_normal((ns * nang, nrad, nrad))
    Pd = torch.tensor(X + X.transpose(0, 2, 1), device=dev)
    return tei, torch.tensor(fem.gidx, dtype=torch.int32, device=dev), Pd


# K10 on random tables: label -> (_random_erfc_inputs keywords, the plan's
# (MT, NG) and whether it splits the rows), one shape per instance of the
# kernel (re_kernel) and plan branch
ERFC_SHAPES = {
    "np4": (dict(nnodes=4), (1, 8), False),  # KS 1
    "np8": (dict(nnodes=8), (1, 8), False),  # KS 2
    "np9_96cols": (dict(nnodes=9, nang=24), (2, 4), False),  # KS 3, 96 columns in one part
    "np15": (dict(nnodes=15), (2, 4), False),  # KS 4
    "np18": (dict(nnodes=18), (1, 4), False),  # KS 5
    "np20": (dict(nnodes=20), (1, 4), False),
    "np21_24cols": (dict(nnodes=21, nang=12), (1, 4), False),  # run-time depth
    "hip_np22": (dict(nnodes=11, primbas=5), (1, 1), False),
    "np40_rows16": (dict(nnodes=40, nelem=2, NL=1, nang=17), (1, 1), True),
    "np48_rows8": (dict(nnodes=48, nelem=2, NL=1), (1, 1), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("shape", list(ERFC_SHAPES))
def test_erfc_exchange_kernel_matches_plain_on_card(cuda_device, shape, ns):
    """K10 on random tables at every instance of the kernel and plan
    branch: 1e-12 x max-abs of the plain version, equal bits twice, one
    launch per call."""
    kw, want, rows = ERFC_SHAPES[shape]
    args = _random_erfc_inputs(cuda_device, ns=ns, **kw)
    tei, gidx, Pd = args
    p = _wrapper_module("radial_erfc_exchange").plan(
        tei.shape[0], Pd.shape[0], tei.shape[1], gidx.shape[1], Pd.shape[1])
    assert ((p.MT, p.NG), p.JP < gidx.shape[1]) == (want, rows)
    out = _check_twice("radial_erfc_exchange", args)
    ref = kernels.radial_erfc_exchange_plain(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("shape", ["ar", "xe"])
def test_erfc_exchange_kernel_at_bench_shapes_on_card(cuda_device, shape, ns):
    """K10 on the erfc tables of the Ar and Xe bench bases (chip_smoke.py's
    phase 18 inputs)."""
    import chip_smoke as cs

    work, _ = cs.erfc_inputs(shape, cuda_device, ns)
    args = work["radial_erfc_exchange"][0]
    out = _check_twice("radial_erfc_exchange", args)
    ref = kernels.radial_erfc_exchange_plain(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.5, 5.0])
def test_radial_exchange_on_yukawa_tables_on_card(cuda_device, lam):
    """K1 on Yukawa tables at rmax 40 (i_L reaches ~1e84 at lam = 5 on the
    Ar bench basis) against the pairwise plain version."""
    import chip_smoke as cs

    args = cs.yukawa_inputs(lam, cuda_device)[0]
    out = _check_twice("radial_exchange", args)
    ref = kernels.radial_exchange_pairwise_plain(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(ERFC_SHAPES))
def test_erfc_plan_matches_kernel_smem(cuda_device, shape):
    """K10's wrapper plans its shared memory as the kernel counts it."""
    from helfem_tpu_torch.kernels import _build, _radial

    mod = _wrapper_module("radial_erfc_exchange")
    mod._templates.clear()
    kernels.radial_erfc_exchange(*_random_erfc_inputs(cuda_device, ns=2,
                                                      **ERFC_SHAPES[shape][0]))
    assert mod._templates
    for t, *_, (_, _, plan) in [v[1] for v in mod._templates.values()]:
        assert _build.lib().radial_erfc_exchange_smem(ctypes.byref(t)) == plan.smem
        assert plan.smem <= _radial.SMEM_BLOCK


def _erfc_ne_windows(dev, symm):
    """The Ne lmax=2, mmax=1 field basis's erfc tables (omega 0.5) and its
    channel-pair windows at symmetry 1 (17) or 0 (49, more than 32)."""
    import chip_smoke as cs

    basis = AtomicBasis(**cs.FIELD_SHAPES["ne_l2"])
    ops = basis.build_operators(dev)
    rs = basis.build_erfc(cs.RS_OMEGA, dev)
    return rs.tei, ops.gidx, cs.pair_window_inputs(basis, ops, symm, 41 + symm)


@pytest.mark.cuda
@pytest.mark.parametrize("symm, nwin", [(1, 17), (0, 49)])
def test_erfc_exchange_kernel_on_ne_windows_on_card(cuda_device, symm, nwin):
    """K10 on the non-symmetric channel-pair windows of Ne lmax=2, mmax=1:
    1e-12 x max-abs of the plain version, equal bits twice."""
    args = _erfc_ne_windows(cuda_device, symm)
    assert args[2].shape[0] == nwin
    out = _check_twice("radial_erfc_exchange", args)
    ref = kernels.radial_erfc_exchange_plain(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
def test_erfc_exchange_kernel_at_one_element_on_card(cuda_device, ns):
    """K10 at nelem 1: one slab, diagonal, and no boundary function."""
    args = _random_erfc_inputs(cuda_device, 8, ns, nelem=1)
    out = _check_twice("radial_erfc_exchange", args)
    ref = kernels.radial_erfc_exchange_plain(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ar", "xe"])
def test_erfc_table_is_packed_once_and_read_once(cuda_device, shape):
    """The table set is packed once (a second call, and a call with twice
    the channels, hit the cache) and each slab is read once per call: the
    bytes the kernel's bulk copies request are the packed table's within
    10 %."""
    import chip_smoke as cs

    mod = _wrapper_module("radial_erfc_exchange")
    work, rs = cs.erfc_inputs(shape, cuda_device, 1)
    tei, gidx, Pd = work["radial_erfc_exchange"][0]
    calls = []
    pack = mod.pack_erfc_table

    def counted(*a, **k):
        calls.append(1)
        return pack(*a, **k)

    mod.pack_erfc_table = counted
    try:
        kernels.radial_erfc_exchange(tei, gidx, Pd)
        kernels.radial_erfc_exchange(tei, gidx, Pd)
        kernels.radial_erfc_exchange(tei, gidx, torch.cat([Pd, Pd]))
    finally:
        mod.pack_erfc_table = pack
    assert len(calls) == 1
    packed = mod._packed(tei)
    issued = mod.issued_bytes(tei, gidx, Pd)
    assert abs(issued - 8 * packed.numel()) <= 0.1 * 8 * packed.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("method, nel", [("LC-LDA", (2, 2)), ("lcy-lda[omega=0.7]", (2, 1)),
                                         ("SR-PBE0", (2, 1))])
def test_rs_scf_on_card_matches_cpu(cuda_device, method, nel):
    """Range-separated SCFs on the card: K10 (erfc) or K1 on the Yukawa
    tables once per Fock build, the CPU's energy within 1e-10 Eh."""
    cfg = dict(Z=sum(nel), lmax=1, mmax=1, rmax=15.0, nelem=5, nnodes=8)
    cpu = scf_atom(AtomicBasis(**cfg), *nel, method=method, convthr=1e-10, device="cpu")
    kernels.reset_launches()
    gpu = scf_atom(AtomicBasis(**cfg), *nel, method=method, convthr=1e-10, device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-10
    erfc = "lcy" not in method.lower()
    assert kernels.launches["radial_erfc_exchange"] == (gpu.niter if erfc else 0)
    assert kernels.launches["radial_exchange"] == gpu.niter * ((method != "SR-PBE0") + (not erfc))


def test_plain_exchange_matches_element_pair_reference(host):
    """Element-pair loops (the reference's TwoDBasis.cpp:987-1135 layout)."""
    basis, ops = host
    args = _inputs(basis, ops, "cpu")["radial_exchange"]
    _close_blocks(kernels.radial_exchange_plain(*args).numpy(),
                  _exchange_pair_reference(args, basis.nrad))


def test_plain_coulomb_matches_element_loop_reference(host):
    basis, ops = host
    args = _inputs(basis, ops, "cpu")["radial_coulomb"]
    got = kernels.radial_coulomb_plain(*args).numpy()
    Paux, tei, U, V, Lfac, gidx = (a.numpy() for a in args)
    ne = gidx.shape[0]
    for L in range(Paux.shape[0]):
        for M in range(Paux.shape[1]):
            Pg = [_windows(Paux[L, M], gidx, basis.nrad)[e, e] for e in range(ne)]
            ts = [np.sum(U[L, e] * Pg[e]) for e in range(ne)]
            tb = [np.sum(V[L, e] * Pg[e]) for e in range(ne)]
            Kp = np.zeros((ne, ne) + Pg[0].shape)
            for e in range(ne):
                Kp[e, e] = Lfac[L] * (V[L, e] * sum(ts[:e]) + U[L, e] * sum(tb[e + 1:])
                                      + np.einsum("ijkl,kl->ij", tei[L, e], Pg[e]))
            ref = _assemble(Kp, gidx, basis.nrad)
            assert np.abs(got[L, M] - ref).max() <= TOL * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("primbas,nnodes,zeroder",
                         [(4, 6, False), (4, 15, False), (8, 5, False), (11, 3, False),
                          (5, 6, True), (8, 5, True)],
                         ids=["lip6", "lip15", "hermite_nder2", "hermite_nder5",
                              "hermite_zeroder", "hermite_nder2_zeroder"])
def test_owner_table_matches_a_scan_of_gidx(primbas, nnodes, zeroder):
    """The host-built owner table against a direct scan of gidx: the slots
    e * nprim + i holding each radial index, in element order; with
    zeroder the dropped derivative DOFs at the last boundary are trash slots
    that no radial index owns."""
    from helfem_tpu_torch.ops.fem import FEMBasis
    from helfem_tpu_torch.ops.polynomials import get_basis

    fem = FEMBasis(get_basis(primbas, nnodes), np.linspace(0.0, 5.0, 5),
                   drop_last_deriv=zeroder)
    if zeroder:
        full = FEMBasis(get_basis(primbas, nnodes), np.linspace(0.0, 5.0, 5))
        nder = len(fem.poly.right_dofs(deriv=True))
        assert nder >= 1 and fem.nbf == full.nbf - nder
        assert (fem.gidx[-1] == fem.nbf).sum() == (full.gidx[-1] == full.nbf).sum() + nder
    got = kernels.owner_table(fem.gidx, fem.nbf)
    flat = fem.gidx.ravel()
    for n in range(fem.nbf):
        slots = [s for s in range(flat.size) if flat[s] == n]
        assert 1 <= len(slots) <= 2
        assert got[n].tolist() == slots + [-1] * (2 - len(slots))
    assert got.dtype == np.int32 and got.shape == (fem.nbf, 2)


@pytest.mark.parametrize("ncols", [1, 5, 8, 13, 29, 33])
def test_radial_plans_admit_wide_elements(ncols):
    """K1's and K2's tile plans take nprim 2-40 with up to 33 channels and
    fit the card's shared memory; the whole depth is one chunk at the bench
    shapes."""
    from helfem_tpu_torch.kernels import _radial

    rc, rx = _wrapper_module("radial_coulomb"), _wrapper_module("radial_exchange")
    for nprim in range(2, 41):
        nelem, NL = 10, 7
        nrad = nelem * (nprim - 1) - 1
        fixed = _radial.fixed_bytes(nelem, nprim, nrad) + 4 * (nelem * nprim + nrad)
        c = rc.plan(NL, ncols, nelem, nprim, nrad)
        band, cross = rx.plan(NL, ncols, nelem, nprim, nrad)
        for p in (c, band):
            assert p.R % 8 == 0 and 8 <= p.R <= 64 and p.CG % 8 == 0 and p.CG <= 32
            assert 1 <= p.NU <= nprim and p.CG * -(-ncols // 32) >= ncols
            assert fixed + 8 * _radial.band_doubles(p.R, p.CG, p.NU, nprim) <= _radial.SMEM_BLOCK
        assert 1 <= cross.AG <= ncols and 1 <= cross.GG <= NL
        assert fixed + 8 * _radial.cross_doubles(cross.AG, cross.GG, nprim) <= _radial.SMEM_BLOCK
    assert rc.plan(3, 5, 10, 15, 139).NU == 15 and rc.plan(7, 13, 8, 12, 87).NU == 12
    assert rx.plan(3, 4, 10, 15, 139)[0].NU == 15 and rx.plan(7, 16, 8, 12, 87)[0].NU == 12


def test_radial_exchange_plan_raises_past_shared_memory():
    """The one shape limit left: K1's cross tiles of one element pair need
    (3 np8 ldw + 8 np8 20) doubles; nprim 68 fits the card's 227 KB, 69 and
    more do not, and the error names the shape. K2 plans far beyond."""
    rc, rx = _wrapper_module("radial_coulomb"), _wrapper_module("radial_exchange")
    rx.plan(3, 4, 2, 68, 133)
    rc.plan(3, 29, 2, 200, 397)
    for nprim in (69, 96, 120):
        with pytest.raises(ValueError, match=f"nprim={nprim} needs"):
            rx.plan(3, 4, 2, nprim, 2 * nprim - 3)


@pytest.mark.parametrize("S", [1, 2, 3, 7, 15, 16, 27, 30])
def test_coulomb_dia_plan_covers_every_slice_once(S):
    """K3's host plan for nprim 2-40: its row tasks cover every row and
    every column of every (group, element) slice exactly once, within the
    card's shared memory; the
    channel groups hold every channel once, beside the channels of its
    table row (one group per row on the SCF path, the +-M pairs of a row
    together when every signed channel runs)."""
    mod = _wrapper_module("radial_coulomb_dia")
    rng = np.random.default_rng(S)
    for ilm in (np.arange(S), rng.integers(0, max(1, S // 2), S)):
        groups, slot, CH = mod.channel_groups(ilm)
        assert CH == (2 if len(set(ilm.tolist())) < S else 1)
        for s, c in enumerate(ilm):
            g, k = divmod(int(slot[s]), CH)
            assert groups[g, 0] == c and groups[g, 1 + k] == s
        assert sorted(groups[:, 1:][groups[:, 1:] >= 0].tolist()) == list(range(S))
        assert len(groups) == sum(-(-int((ilm == c).sum()) // CH) for c in set(ilm.tolist()))
        G, nelem = len(groups), 3
        for nprim in range(2, 41):
            np2, nrad = nprim * nprim, nelem * (nprim - 1) - 1
            for nblocks in (132, 396):
                p = mod.plan(S, G, CH, nelem, nprim, nrad, nblocks)
                assert p.R % 8 == 0 and 8 <= p.R <= mod.MAX_R and 1 <= p.K <= mod.MAX_K
                assert 32 * (p.K - 1) < p.W <= 32 * p.K and p.ncb * p.W >= np2
                assert mod.smem_bytes(CH, p.W, p.K, p.R, S, nelem, nprim, nrad) <= mod.SMEM_BLOCK
                cover = {}
                for g, e, r0, nr, c0, nc in mod.tasks(p, G, nelem, nprim):
                    cover.setdefault((g, e), []).append((r0, nr, c0, nc))
                assert sorted(cover) == [(g, e) for g in range(G) for e in range(nelem)]
                for tiles in cover.values():
                    rows = sorted({(r0, nr) for r0, nr, _, _ in tiles})
                    cols = sorted({(c0, nc) for _, _, c0, nc in tiles})
                    assert len(tiles) == len(rows) * len(cols) == p.nrb * p.ncb
                    assert len(set(tiles)) == len(tiles)
                    for spans, total in ((rows, np2), (cols, np2)):
                        assert spans[0][0] == 0 and all(n > 0 for _, n in spans)
                        assert all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
                        assert spans[-1][0] + spans[-1][1] == total


def test_exchange_planners_admit_wide_elements_and_raise_past_shared_memory():
    """K6 and K7 past the old nprim 32: their shared-memory plans admit
    nprim 33 and 40 (K6 up to 62 with one occupied column; K7's in-element
    GEMM up to 72, its cross-element kernel up to 69), and one past each
    limit the planner raises a ValueError naming the shape."""
    from helfem_tpu_torch.kernels.radial_exchange_dia import (
        _SMEM, _column_chunks, _cross_dense_smem, _inelem_plan,
    )

    occ, dense = "radial_exchange_dia_occ", "radial_exchange_dia"
    for nprim in (33, 40, 62):
        assert _inelem_plan(occ, nprim, 1)[1] <= _SMEM
        assert _column_chunks(occ, nprim, 9)[-1][1] == 9
    for nprim in (33, 40, 69):
        assert _inelem_plan(dense, nprim, None)[1] <= _SMEM
        assert _cross_dense_smem(dense, nprim) <= _SMEM
    assert _inelem_plan(dense, 72, None)[1] <= _SMEM
    with pytest.raises(ValueError, match="no=1 occupied columns at nprim=63 need"):
        _column_chunks(occ, 63, 9)
    with pytest.raises(ValueError, match="nprim=73 needs .* two stages"):
        _inelem_plan(dense, 73, None)
    with pytest.raises(ValueError, match="nprim=70 needs .* cross-element"):
        _cross_dense_smem(dense, 70)


def test_check_gidx_rejects_triple_cover():
    kernels.check_gidx(np.array([[3, 0, 1], [1, 2, 3]], dtype=np.int32), 3)
    with pytest.raises(ValueError, match="two"):
        kernels.check_gidx(np.array([[0, 1], [1, 2], [1, 3]], dtype=np.int32), 4)


@pytest.mark.parametrize("bad", [-1, 4], ids=["negative", "past_trash"])
def test_check_gidx_rejects_out_of_range(bad):
    with pytest.raises(ValueError, match="must lie in"):
        kernels.check_gidx(np.array([[bad, 0, 1], [1, 2, 3]], dtype=np.int32), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["radial_exchange", "radial_coulomb"])
def test_kernel_matches_plain_on_card(host, cuda_device, name):
    basis, ops = host
    args = _inputs(basis, ops, cuda_device)[name]
    before = kernels.launches[name]
    out = getattr(kernels, name)(*args)
    again = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = getattr(kernels, name + "_plain")(*args)
    assert torch.equal(out, again)  # owner-computes assembly: deterministic
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["radial_exchange", "radial_coulomb"])
def test_kernel_rejects_bad_inputs_on_card(host, cuda_device, name):
    basis, ops = host
    args = list(_inputs(basis, ops, cuda_device)[name])
    fn = getattr(kernels, name)
    with pytest.raises(TypeError):
        fn(*([args[0].float()] + args[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        fn(*([args[0].transpose(-1, -2)] + args[1:]))
    with pytest.raises(ValueError, match="shape"):
        fn(*(args[:-1] + [args[-1][..., :-1].contiguous()]))


# the K1/K2 shapes of chip_smoke.py: the Ar and Xe bench bases, and random
# tables at nprim 33 and 40, at NM 29 with nprim 32 (64 exchange channels)
# and in a Hermite element layout
RADIAL_SHAPES = ["ar", "xe", "np33", "np40", "nm29_np32", "hermite"]


def _radial_inputs(shape, dev):
    import chip_smoke as cs

    if shape in cs.SHAPES:
        return cs.kernel_inputs(cs.SHAPES[shape], dev)
    return cs.random_atomic_inputs(dev, *cs.WIDE_SHAPES[shape])


def _check_twice(name, args, fn=None):
    """Two calls of the kernel: one launch each, the same bits, and within
    TOL x max-abs of the plain version."""
    fn = fn or getattr(kernels, name)
    before = kernels.launches[name]
    out = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    assert torch.equal(out, again)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RADIAL_SHAPES)
@pytest.mark.parametrize("name", ["radial_exchange", "radial_coulomb"])
def test_radial_kernel_matches_plain_at_bench_and_wide_shapes(cuda_device, name, shape):
    """K1 and K2 at the bench shapes and past the old nprim 32 and 227 KB
    limits: 1e-12 x max-abs of the plain version, equal bits twice, one
    launch per call."""
    args = _radial_inputs(shape, cuda_device)[name][0]
    out = _check_twice(name, args)
    ref = getattr(kernels, name + "_plain")(*args)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_exchange_kernel_L_batch_on_card(cuda_device):
    """exchange_kernel_L's call: one multipole channel (NL = 1) on a batch of
    radial matrices, views of the operators each call (the sadatom shape)."""
    import chip_smoke as cs
    from helfem_tpu_torch.models import atomic

    args = cs.kernel_inputs(cs.SHAPES["ar"], cuda_device)["radial_exchange"][0]
    tei, U, V, gidx, Pd = args
    nrad = Pd.shape[-1]
    R = torch.tensor(np.random.default_rng(5).standard_normal((6, nrad, nrad)),
                     device=cuda_device)
    for L in range(tei.shape[0]):
        out = _check_twice("radial_exchange", (tei[L], U[L], V[L], gidx, nrad, R),
                           atomic.exchange_kernel_L)
        ref = kernels.radial_exchange_plain(tei[L:L + 1], U[L:L + 1], V[L:L + 1], gidx, R)[0]
        assert out.shape == (6, nrad, nrad)
        assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RADIAL_SHAPES)
def test_radial_plan_matches_kernel_smem(cuda_device, shape):
    """The wrappers' plans count the kernels' shared memory as the kernels do."""
    from helfem_tpu_torch.kernels import _build, _radial

    inputs = _radial_inputs(shape, cuda_device)
    for name in ("radial_exchange", "radial_coulomb"):
        mod = _wrapper_module(name)
        args = inputs[name][0]
        getattr(kernels, name)(*args)
        for t, *_ in [v[1] for v in mod._templates.values()]:
            fixed = _radial.fixed_bytes(t.nelem, t.nprim, t.nrad)
            band = _radial.band_doubles(t.R, t.CG, t.NU, t.nprim)
            if name == "radial_exchange":  # the slot table, the shared functions
                band = max(band, _radial.cross_doubles(t.AG, t.GG, t.nprim))
                fixed += 4 * (t.nelem * t.nprim + t.nrad)
            else:  # the column bands, each warp's prefix and suffix sums
                band += 2 * _radial.WARPS * t.nelem
                fixed += 8 * t.nrad
            want = fixed + 8 * band
            assert getattr(_build.lib(), f"{name}_smem")(ctypes.byref(t)) == want
            assert want <= _radial.SMEM_BLOCK


@pytest.mark.cuda
def test_scf_on_card_matches_cpu(cuda_device):
    cfg = dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8)
    cpu = scf_atom(AtomicBasis(**cfg), 5, 5, convthr=1e-10, device="cpu")
    before = dict(kernels.launches)
    gpu = scf_atom(AtomicBasis(**cfg), 5, 5, convthr=1e-10, device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-10
    assert all(kernels.launches[k] > before[k] for k in ("radial_exchange", "radial_coulomb"))


# the spherically averaged atom at chip_smoke.py's shapes: gensap Kr of the
# bench (K2 only: SVWN) and SAD-HF Ar at the Ar bench basis (K1 at NL 3 on
# two channels, K2)
SAD_SHAPES = {
    "kr_gensap": dict(Z=36, lmax=2, rmax=40.0, nelem=8, nnodes=12),
    "ar_hf": dict(Z=18, lmax=1, rmax=40.0, nelem=10, nnodes=15),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SAD_SHAPES))
def test_sad_fock_pieces_match_plain_on_card(cuda_device, shape):
    """sad_exchange (one K1 launch for every (L, channel)) and sad_coulomb
    (one K2 launch on the L=0 tables) on the card against the same
    functions on CPU tensors: 1e-12 x max-abs, the same bits twice, one
    launch per call."""
    from helfem_tpu_torch.models import sadatom

    basis = sadatom.SadAtomBasis(**SAD_SHAPES[shape])
    host_ops = basis.host_ops()
    cpu = sadatom.from_jax_sad_ops(host_ops, "cpu")
    gpu = sadatom.from_jax_sad_ops(host_ops, cuda_device)
    X = np.random.default_rng(47).standard_normal((basis.lmax + 1, basis.nrad, 4))
    Pang = np.einsum("lik,ljk->lij", X, X)
    for fn, name, P in ((sadatom.sad_exchange, "radial_exchange", Pang),
                        (sadatom.sad_coulomb, "radial_coulomb", Pang.sum(0))):
        out = _check_twice(name, (gpu, torch.tensor(P, device=cuda_device)), fn).cpu()
        ref = fn(cpu, torch.tensor(P))
        assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_sad_solve_on_card_matches_cpu(cuda_device):
    """SAD-HF Ne with the occupation search: the same energy and
    configuration, K1 and K2 once per Fock build."""
    from helfem_tpu_torch.models import sadatom

    basis = sadatom.SadAtomBasis(Z=10, lmax=1, nelem=5, nnodes=8)
    cpu = sadatom.solve_sadatom(basis, method="HF", convthr=1e-9, device="cpu")
    kernels.reset_launches()
    gpu = sadatom.solve_sadatom(basis, method="HF", convthr=1e-9, device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9
    assert list(gpu.occs) == list(cpu.occs) == [4, 6]
    assert kernels.launches["radial_exchange"] == kernels.launches["radial_coulomb"] == gpu.nfock


DIA_CONFIGS = {
    # the N2 bench shapes, and a heteronuclear CO where odd-L channels live
    "n2_bench": dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8),
    "co_l4": dict(Z1=6, Z2=8, Rbond=2.132, lmax=(4, 4), rmax=25.0, nelem=4, nnodes=8),
    # nprim^2 = 25 and nq = 25: blocks that are not a whole number of warps
    "lih_np5": dict(Z1=3, Z2=1, Rbond=3.015, lmax=(3, 2, 1), rmax=20.0, nelem=3, nnodes=5),
}
DIA_KERNELS = ["radial_coulomb_dia", "dia_xc_fields", "dia_xc_fock",
               "radial_exchange_dia_occ", "radial_exchange_dia"]


@pytest.fixture(scope="module", params=list(DIA_CONFIGS), ids=list(DIA_CONFIGS))
def dia_basis(request):
    return DiatomicBasis(**DIA_CONFIGS[request.param])


def _dia_inputs(basis, dev, seed=43):
    """Each diatomic kernel's inputs for a random symmetric
    symmetry-block-diagonal density, and the XC kernels' for two spins
    (chip_smoke.xc_kernel_inputs)."""
    from chip_smoke import xc_kernel_inputs

    ops = basis.build_operators(dev)
    rng = np.random.default_rng(seed)
    P = np.zeros((basis.nbf, basis.nbf))
    for idx in basis.sym_blocks():
        X = rng.standard_normal((len(idx), len(idx)))
        P[np.ix_(idx, idx)] = X + X.T
    P = torch.tensor(P, device=dev)
    P4 = _to4(P, basis.nang, basis.nrad)
    nj = basis.njbd
    Paux0 = torch.einsum("sab,abIJ->sIJ", ops.GmLM[:nj], P4).contiguous()
    Paux2 = torch.einsum("sab,abIJ->sIJ", ops.GpLM[:nj], P4).contiguous()
    # rank factors of 7 random occupied columns, and the dense R of the same
    # density, as exchange_dia_occ and exchange_dia form them
    Co = torch.tensor(rng.standard_normal((basis.nbf, 7)), device=dev)
    Uw, U = exchange_factors(ops, Co)
    R = exchange_weights(ops, Co @ Co.T)
    xtabs = (ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.step_ilm, ops.gidx)
    return {
        "radial_exchange_dia_occ": (Uw, U, *xtabs),
        "radial_exchange_dia": (R, *xtabs),
        "radial_coulomb_dia": (Paux0, Paux2, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2,
                               ops.LMfac, ops.LM_ilm[:nj], ops.gidx),
        **{name: args for name, (args, _, _) in xc_kernel_inputs(basis, dev, 2, seed).items()},
    }


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", DIA_KERNELS)
def test_dia_kernel_matches_plain_on_card(dia_basis, cuda_device, name):
    args = _dia_inputs(dia_basis, cuda_device)[name]
    before = kernels.launches[name]
    out = _as_tuple(getattr(kernels, name)(*args))
    again = _as_tuple(getattr(kernels, name)(*args))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = _as_tuple(getattr(kernels, name + "_plain")(*args))
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)  # fixed-order sums: deterministic
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", DIA_KERNELS)
def test_dia_kernel_rejects_bad_inputs_on_card(dia_basis, cuda_device, name):
    args = list(_dia_inputs(dia_basis, cuda_device)[name])
    fn = getattr(kernels, name)
    with pytest.raises(TypeError):
        fn(*([args[0].float()] + args[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        fn(*([args[0].transpose(-1, -2)] + args[1:]))
    with pytest.raises(ValueError, match="shape"):
        fn(*([args[0][..., :-1].contiguous()] + args[1:]))


# K3 past the old nprim 32 (the LiH XC shapes below) and with every signed
# channel (njbd None: the +-M channels of a table row share one read of it)
K3_SHAPES = {
    "n2_all": ("n2_bench", False),
    "co_all": ("co_l4", False),
    "lih_all": ("lih_np5", False),
    "np33": ("np33", True),
    "np40": ("np40", True),
}


def _coulomb_dia_args(cfg, dev, prefix, seed=53):
    """K3's arguments for a random symmetric symmetry-block-diagonal density,
    as coulomb_dia(ops, P, basis.njbd if prefix else None) forms them."""
    import chip_smoke as cs

    basis = DiatomicBasis(**cfg)
    ops = basis.build_operators(dev)
    P = cs.block_density(basis, dev, seed)
    return cs.coulomb_dia_inputs(basis, ops, P, basis.njbd if prefix else None)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_coulomb_dia_kernel_matches_plain_on_card(cuda_device, shape):
    """K3 at nprim 33 and 40 and with every signed channel: one launch per
    call, the same bits twice, 1e-12 x max-abs of the plain version."""
    key, prefix = K3_SHAPES[shape]
    cfg = DIA_CONFIGS.get(key) or XC_SHAPES[key]
    args = _coulomb_dia_args(cfg, cuda_device, prefix)
    before = kernels.launches["radial_coulomb_dia"]
    out = kernels.radial_coulomb_dia(*args)
    again = kernels.radial_coulomb_dia(*args)
    torch.cuda.synchronize()
    assert kernels.launches["radial_coulomb_dia"] == before + 2
    ref = kernels.radial_coulomb_dia_plain(*args)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
def test_coulomb_dia_rejects_bad_helpers_on_card(cuda_device):
    """Per call K3 checks Paux0 and Paux2 alone: type, contiguity and the
    shape [S, nrad, nrad] of the operator set's template."""
    args = list(_coulomb_dia_args(DIA_CONFIGS["lih_np5"], cuda_device, True))
    fn = kernels.radial_coulomb_dia
    for k, arg in ((0, "Paux0"), (1, "Paux2")):
        bad = list(args)
        bad[k] = args[k].float()
        with pytest.raises(TypeError, match=arg):
            fn(*bad)
        bad[k] = args[k].transpose(-1, -2)
        with pytest.raises(ValueError, match=f"{arg} must be contiguous"):
            fn(*bad)
        bad[k] = args[k][:-1].contiguous()
        with pytest.raises(ValueError, match=f"{arg} has shape"):
            fn(*bad)
    with pytest.raises(ValueError, match="Paux0 has shape"):
        fn(*([args[0][0]] + args[1:]))


@pytest.mark.cuda
def test_coulomb_dia_reuses_its_template_for_fresh_ilm_views(cuda_device):
    """coulomb_dia passes ops.LM_ilm[:njbd], a new view on every call: the
    launch template is found by its memory, so a second call builds none."""
    from helfem_tpu_torch.models.diatomic import coulomb_dia

    mod = _wrapper_module("radial_coulomb_dia")
    basis = DiatomicBasis(**DIA_CONFIGS["co_l4"])
    ops = basis.build_operators(cuda_device)
    P = torch.tensor(np.eye(basis.nbf), device=cuda_device)
    first = coulomb_dia(ops, P, basis.njbd)
    entries = dict(mod._templates)
    again = coulomb_dia(ops, P, basis.njbd)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert len(mod._templates) == len(entries)
    assert all(mod._templates[k] is v for k, v in entries.items())
    view = ops.LM_ilm[:basis.njbd]
    hits = [v for k, v in entries.items() if view.data_ptr() in [m[0] for m in k[1]]]
    assert hits, "no template is keyed by the memory of ops.LM_ilm[:njbd]"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["n2_bench", "lih_np5"])
def test_coulomb_dia_plan_matches_kernel_smem(cuda_device, shape):
    """The wrapper's plan counts the kernel's shared memory as the kernel
    does, and sizes its tasks by the kernel's cooperative grid."""
    from helfem_tpu_torch.kernels import _build

    mod = _wrapper_module("radial_coulomb_dia")
    mod._templates.clear()
    args = _coulomb_dia_args(DIA_CONFIGS[shape], cuda_device, True)
    kernels.radial_coulomb_dia(*args)
    (t, *_), = {id(v[1]): v[1] for v in mod._templates.values()}.values()
    want = mod.smem_bytes(t.CH, t.W, t.K, t.R, t.S, t.nelem, t.nprim, t.nrad)
    assert _build.lib().radial_coulomb_dia_smem(ctypes.byref(t)) == want <= mod.SMEM_BLOCK
    nblocks = _build.lib().radial_coulomb_dia_grid(ctypes.byref(t))
    assert nblocks >= torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert mod.plan(t.S, t.G, t.CH, t.nelem, t.nprim, t.nrad, nblocks).R == t.R


@pytest.mark.cuda
def test_dia_scf_on_card_matches_cpu(cuda_device):
    cfg = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
    cpu = scf_diatomic(DiatomicBasis(**cfg), 7, 7, method="PBE", convthr=1e-9, device="cpu")
    before = dict(kernels.launches)
    gpu = scf_diatomic(DiatomicBasis(**cfg), 7, 7, method="PBE", convthr=1e-9,
                       device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9
    assert all(kernels.launches[k] > before[k] for k in DIA_KERNELS[:3])
    assert all(kernels.launches[k] == before[k] for k in DIA_KERNELS[3:])  # no exchange in PBE


# XC kernel shapes: the N2 bench and CO bases, the N2 lmax=12 bench basis,
# elements past the old kernels' nprim 32, and more radial points per
# element than the old K5's 2048
XC_SHAPES = {
    "n2": dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8),
    "co": DIA_CONFIGS["co_l4"],
    "lmax12": dict(Z1=7, Z2=7, Rbond=2.068, lmax=(12, 12, 12), rmax=40.0, nelem=5, nnodes=15),
    "np33": dict(Z1=3, Z2=1, Rbond=3.015, lmax=(2, 1), rmax=20.0, nelem=2, nnodes=33),
    "np40": dict(Z1=3, Z2=1, Rbond=3.015, lmax=(2, 1), rmax=20.0, nelem=2, nnodes=40),
    "nq2100": dict(Z1=3, Z2=1, Rbond=3.015, lmax=(2, 1), rmax=20.0, nelem=2, nnodes=8,
                   nquad=2100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("shape", list(XC_SHAPES))
@pytest.mark.parametrize("name", ["dia_xc_fields", "dia_xc_fock"])
def test_xc_kernel_matches_plain_on_card(cuda_device, name, shape, ns):
    """K4 and K5 for one and two spins: one launch per call, 1e-12 x
    max-abs of each output against the plain version, the same bits from
    two calls."""
    from chip_smoke import xc_kernel_inputs

    args = xc_kernel_inputs(DiatomicBasis(**XC_SHAPES[shape]), cuda_device, ns, 47)[name][0]
    before = kernels.launches[name]
    out = _as_tuple(getattr(kernels, name)(*args))
    again = _as_tuple(getattr(kernels, name)(*args))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = _as_tuple(getattr(kernels, name + "_plain")(*args))
    for o, a, r in zip(out, again, ref):
        assert o.shape[0] == ns and torch.equal(o, a)
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("shape", ["ar", "xe", "sad_kr"])
@pytest.mark.parametrize("name", ["dia_xc_fields", "dia_xc_fock"])
def test_xc_kernel_matches_plain_on_atomic_grids(cuda_device, name, shape, ns):
    """K4 and K5 on the atomic grids of the Ar and Xe bench bases (densities
    dense over the same-m shell pairs) and on the SAD grid of gensap Kr (one
    angular shell and point): one launch per call, 1e-12 x max-abs of each
    output against the plain version, the same bits from two calls."""
    from chip_smoke import atomic_xc_inputs

    args = atomic_xc_inputs(shape, cuda_device, ns, 61)[name][0]
    before = kernels.launches[name]
    out = _as_tuple(getattr(kernels, name)(*args))
    again = _as_tuple(getattr(kernels, name)(*args))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = _as_tuple(getattr(kernels, name + "_plain")(*args))
    for o, a, r in zip(out, again, ref):
        assert o.shape[0] == ns and torch.equal(o, a)
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("shape", ["n2", "lmax12", "np40", "ar", "xe", "sad_kr"])
@pytest.mark.parametrize("name", ["dia_xc_fields", "dia_xc_fock"])
def test_xc_tau_mode_matches_plain_on_card(cuda_device, name, shape, ns):
    """K4 and K5 in tau mode (meta-GGAs) on diatomic, atomic and SAD grids
    (the SAD grid's two-shell meta-GGA form) for one and two spins: one
    launch per call, 1e-12 x max-abs of each output (tau included) against
    the plain version, the same bits from two calls."""
    from chip_smoke import atomic_xc_inputs, xc_kernel_inputs

    if shape in XC_SHAPES:
        inputs = xc_kernel_inputs(DiatomicBasis(**XC_SHAPES[shape]), cuda_device, ns, 71,
                                  tau=True)
    else:
        inputs = atomic_xc_inputs(shape, cuda_device, ns, 73, tau=True)
    args = inputs[name][0]
    before = kernels.launches[name]
    out = _as_tuple(getattr(kernels, name)(*args))
    again = _as_tuple(getattr(kernels, name)(*args))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = _as_tuple(getattr(kernels, name + "_plain")(*args))
    assert len(out) == len(ref) == (4 if name == "dia_xc_fields" else 1)
    for o, a, r in zip(out, again, ref):
        assert o.shape[0] == ns and torch.equal(o, a)
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("shape", ["n2", "lmax12", "np40", "ar", "xe"])
@pytest.mark.parametrize("name", ["dia_xc_fields", "dia_xc_fock"])
def test_xc_lapl_mode_matches_plain_on_card(cuda_device, name, shape, ns):
    """K4 and K5 in laplacian mode (BR89) on diatomic and atomic grids built
    with their laplacian tables, for one and two spins: one launch per
    call, 1e-12 x max-abs of each output (tau and the laplacian included)
    against the plain version, the same bits from two calls."""
    from chip_smoke import atomic_xc_inputs, xc_kernel_inputs

    if shape in XC_SHAPES:
        inputs = xc_kernel_inputs(DiatomicBasis(**XC_SHAPES[shape]), cuda_device, ns, 131,
                                  lapl=True)
    else:
        inputs = atomic_xc_inputs(shape, cuda_device, ns, 137, lapl=True)
    args = inputs[name][0]
    before = kernels.launches[name]
    out = _as_tuple(getattr(kernels, name)(*args))
    again = _as_tuple(getattr(kernels, name)(*args))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = _as_tuple(getattr(kernels, name + "_plain")(*args))
    assert len(out) == len(ref) == (5 if name == "dia_xc_fields" else 1)
    for o, a, r in zip(out, again, ref):
        assert o.shape[0] == ns and torch.equal(o, a)
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.parametrize("nprim, nq", [(8, 40), (15, 75), (40, 200), (120, 600)])
def test_fields_plan_lapl_mode(nprim, nq):
    """K4's plan in laplacian mode: the windows and the three staged element
    tables (B, dB, d2B) each within 64 KB, room for phase 2's nine partial
    tiles, and within the card's shared memory."""
    from helfem_tpu_torch.kernels.dia_xc_fields import _ld, fields_plan

    pc, qc, smem = fields_plan(nprim, nq, True, True)
    mp = -(-nprim // 8) * 8
    assert pc >= 1 and 8 <= qc <= 128 and qc % 8 == 0
    assert 3 * mp * _ld(qc) <= 8192 or qc == 8
    assert smem >= 8 * 9 * 8 * 64 and smem <= 232448
    assert smem >= 8 * (pc * mp * _ld(mp) + 3 * mp * _ld(qc)) + 4 * (2 * pc + nprim)
    assert fields_plan(nprim, nq, True)[2] <= smem


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["he", "n_uks", "ne_lyp_dampfock", "h2_shift_diisthr"])
def test_br89_scf_on_card_matches_cpu(cuda_device, case):
    """BR89 SCFs on the card (K4 and K5 in laplacian mode): the CPU's energy
    within 1e-9 Eh in its iteration count, K4 and K5 once per iteration;
    with Fock damping, and with the level shift and the DIIS/ADIIS blend."""
    atom = dict(lmax=1, mmax=1, rmax=30.0, nelem=6, nnodes=8)
    kind, cfg, na, nb, kw = {
        "he": ("atomic", dict(Z=2, lmax=0, mmax=0, rmax=25.0, nelem=8, nnodes=10), 1, 1,
               dict(method="mgga_x_br89", convthr=1e-6, maxit=160)),
        "n_uks": ("atomic", dict(atom, Z=7), 5, 2, dict(method="mgga_x_br89", convthr=1e-8)),
        "ne_lyp_dampfock": ("atomic", dict(atom, Z=10), 5, 5,
                            dict(method="mgga_x_br89,gga_c_lyp", convthr=1e-8, dampfock=0.5,
                                 dampthr=0.01)),
        "h2_shift_diisthr": ("diatomic", dict(Z1=1, Z2=1, Rbond=1.4, lmax=(2,), rmax=10.0,
                                              nelem=2, nnodes=6), 1, 1,
                             dict(method="mgga_x_br89", convthr=1e-8, maxit=100, shift=1.0,
                                  diiseps=5.0, diisthr=0.01)),
    }[case]
    run = (lambda dev: scf_atom(AtomicBasis(**cfg), na, nb, device=dev, **kw)) \
        if kind == "atomic" else \
        (lambda dev: scf_diatomic(DiatomicBasis(**cfg), na, nb, device=dev, **kw))
    cpu = run("cpu")
    kernels.reset_launches()
    gpu = run(cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9 and gpu.niter == cpu.niter
    assert kernels.launches["dia_xc_fields"] == kernels.launches["dia_xc_fock"] == gpu.niter


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["he_tpss", "li_uks_tpss", "be_scan", "he_b3lyp5"])
def test_mgga_scf_on_card_matches_cpu(cuda_device, case):
    """Meta-GGA and B3LYP5 atomic SCFs on the card: the CPU's energy within
    1e-9 Eh; K4 and K5 once per iteration (tau mode for the meta-GGAs), K1
    once per iteration for the hybrid."""
    Z, na, nb, method = {"he_tpss": (2, 1, 1, "TPSS"), "li_uks_tpss": (3, 2, 1, "TPSS"),
                         "be_scan": (4, 2, 2, "SCAN"), "he_b3lyp5": (2, 1, 1, "B3LYP5")}[case]
    cfg = dict(Z=Z, lmax=0, mmax=0, rmax=40.0, nelem=5, nnodes=8)
    cpu = scf_atom(AtomicBasis(**cfg), na, nb, method=method, convthr=1e-10, device="cpu")
    kernels.reset_launches()
    gpu = scf_atom(AtomicBasis(**cfg), na, nb, method=method, convthr=1e-10,
                   device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9
    n = gpu.niter
    assert kernels.launches["dia_xc_fields"] == kernels.launches["dia_xc_fock"] == n
    assert kernels.launches["radial_exchange"] == (n if method == "B3LYP5" else 0)


@pytest.mark.cuda
def test_mgga_sad_and_diatomic_on_card_match_cpu(cuda_device):
    """sad_xc with TPSS on the card (one K4 and one K5 launch per call, the
    per-l cube within 1e-12 x max-abs of the CPU's), and He as a diatomic
    (Z2 = 0) with TPSS: the CPU's energy within 1e-9 Eh."""
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.ops.xc import parse_method

    basis = sadatom.SadAtomBasis(**SAD_SHAPES["kr_gensap"])
    host_ops = basis.host_ops()
    cpu = sadatom.from_jax_sad_ops(host_ops, "cpu")
    gpu = sadatom.from_jax_sad_ops(host_ops, cuda_device)
    funcs = tuple(parse_method("TPSS")[0])
    rng = np.random.default_rng(79)
    Pa, Pb = (np.einsum("lik,ljk->lij", X, X) for X in
              rng.standard_normal((2, basis.lmax + 1, basis.nrad, 4)))
    for spins in ((Pa,), (Pa, Pb)):
        t = [torch.tensor(P, device=cuda_device) for P in spins]
        c = [torch.tensor(P) for P in spins]
        before = {k: kernels.launches[k] for k in ("dia_xc_fields", "dia_xc_fock")}
        out = sadatom.sad_xc(funcs, gpu, t[0], t[-1])
        torch.cuda.synchronize()
        assert all(kernels.launches[k] == before[k] + 1 for k in before)
        ref = sadatom.sad_xc(funcs, cpu, c[0], c[-1])
        assert out[0].shape == (basis.lmax + 1, basis.nrad, basis.nrad)
        for o, r in zip(out, ref):
            assert float((o.cpu() - r).abs().max()) <= TOL * float(r.abs().max())
    cfg = dict(Z1=2, Z2=0, Rbond=2.0, lmax=(4,), rmax=20.0, nelem=4, nnodes=8)
    cpu_r = scf_diatomic(DiatomicBasis(**cfg), 1, 1, method="TPSS", convthr=1e-8, guess="SAP",
                         device="cpu")
    gpu_r = scf_diatomic(DiatomicBasis(**cfg), 1, 1, method="TPSS", convthr=1e-8, guess="SAP",
                         device=cuda_device)
    assert gpu_r.converged and abs(gpu_r.E - cpu_r.E) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ne_pbe0", "n_uks_pbe", "n_rohf"])
def test_atomic_dft_and_open_shells_on_card_match_cpu(cuda_device, case):
    """The atomic SCF with a hybrid, UKS and ROHF on the card: the CPU's
    energy within 1e-9 Eh; K2 once per iteration, K1 once per iteration
    for PBE0 and ROHF (both spins in one launch), K4 and K5 once per
    iteration for a functional."""
    Z, na, nb, kw = {"ne_pbe0": (10, 5, 5, dict(method="PBE0")),
                     "n_uks_pbe": (7, 5, 2, dict(method="PBE")),
                     "n_rohf": (7, 5, 2, dict(method="HF", restricted=1))}[case]
    cfg = dict(Z=Z, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8)
    cpu = scf_atom(AtomicBasis(**cfg), na, nb, convthr=1e-10, device="cpu", **kw)
    kernels.reset_launches()
    gpu = scf_atom(AtomicBasis(**cfg), na, nb, convthr=1e-10, device=cuda_device, **kw)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9
    n, dft, hf = gpu.niter, kw["method"] != "HF", kw["method"] != "PBE"
    assert kernels.launches["radial_coulomb"] == n
    assert kernels.launches["radial_exchange"] == (n if hf else 0)
    assert kernels.launches["dia_xc_fields"] == kernels.launches["dia_xc_fock"] == (n if dft
                                                                                     else 0)


@pytest.mark.cuda
def test_sad_xc_on_card_matches_cpu(cuda_device):
    """sad_xc through K4/K5 on the card against the same function on CPU
    tensors, for one and two spin densities: 1e-12 x max-abs of each
    output, one launch of each kernel per call."""
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.ops.xc import parse_method

    basis = sadatom.SadAtomBasis(**SAD_SHAPES["kr_gensap"])
    host_ops = basis.host_ops()
    cpu = sadatom.from_jax_sad_ops(host_ops, "cpu")
    gpu = sadatom.from_jax_sad_ops(host_ops, cuda_device)
    funcs = tuple(parse_method("PBE")[0])
    rng = np.random.default_rng(67)
    Pa, Pb = (np.einsum("lik,ljk->lij", X, X) for X in
              rng.standard_normal((2, basis.lmax + 1, basis.nrad, 4)))
    for spins in ((Pa,), (Pa, Pb)):
        t = [torch.tensor(P, device=cuda_device) for P in spins]
        c = [torch.tensor(P) for P in spins]
        before = {k: kernels.launches[k] for k in ("dia_xc_fields", "dia_xc_fock")}
        out = sadatom.sad_xc(funcs, gpu, t[0], t[-1])
        torch.cuda.synchronize()
        assert all(kernels.launches[k] == before[k] + 1 for k in before)
        ref = sadatom.sad_xc(funcs, cpu, c[0], c[-1])
        for o, r in zip(out, ref):
            assert float((o.cpu() - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
def test_occupied_exchange_in_column_chunks_on_card(cuda_device):
    """K6 at nprim 15 with 48 occupied columns, past the 34 that one launch
    takes: two launches whose sum agrees with the plain version at 1e-12 x
    max-abs, the same bits twice."""
    from chip_smoke import random_exchange_inputs

    name = "radial_exchange_dia_occ"
    args = random_exchange_inputs(cuda_device, nang=9, nprim=15, nelem=2, nlm=2, no=48,
                                  dense_channels=1, seed=23)[name][0]
    before = kernels.launches[name]
    out = kernels.radial_exchange_dia_occ(*args)
    again = kernels.radial_exchange_dia_occ(*args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 4
    ref = kernels.radial_exchange_dia_occ_plain(*args)
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["radial_exchange_dia_occ", "radial_exchange_dia"])
def test_exchange_kernel_matches_plain_at_lmax12_shapes(cuda_device, name):
    """The N2 lmax=12 bench shapes (nang 59, nprim 15, nelem 5, 125 channels,
    no 9) on chip_smoke.py's random tables."""
    from chip_smoke import lmax12_exchange_inputs

    args = lmax12_exchange_inputs(cuda_device)[name][0]
    out = getattr(kernels, name)(*args)
    again = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    ref = getattr(kernels, name + "_plain")(*args)
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


# (nang, nprim, nelem, S, no) at the edges of the exchange core's tiling:
# one element (no cross pairs), one and nine shells (ragged 8 x 8 tiles),
# nprim from 2 past the old limit of 32 (row blocks past 16; np2 past the
# cross kernel's 1024 outputs of one pass), one occupied column and the most
# that the shared-memory plan admits ("max"), one channel
EXCHANGE_EDGES = {
    "nelem1": (9, 5, 1, 3, 3),
    "nang1": (1, 5, 3, 2, 2),
    "nang9": (9, 8, 3, 3, 4),
    "np2": (9, 2, 4, 2, 2),
    "np5": (9, 5, 3, 2, 3),
    "np15": (9, 15, 2, 2, 3),
    "np32": (3, 32, 2, 1, 2),
    "np33": (3, 33, 2, 1, 2),
    "np40": (3, 40, 2, 1, 2),
    "no1": (9, 8, 3, 2, 1),
    "no_max_np15": (9, 15, 2, 1, "max"),
    "no_max_np32": (3, 32, 2, 1, "max"),
    "S1": (9, 8, 3, 1, 3),
}


def _largest_no(nprim):
    """The most occupied columns the exchange wrappers admit at nprim."""
    from helfem_tpu_torch.kernels.radial_exchange_dia import _inelem_plan

    no = 1
    while True:
        try:
            _inelem_plan("radial_exchange_dia_occ", nprim, no + 1)
        except ValueError:
            return no
        no += 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXCHANGE_EDGES))
@pytest.mark.parametrize("name", ["radial_exchange_dia_occ", "radial_exchange_dia"])
def test_exchange_kernel_matches_plain_at_tiling_edges(cuda_device, name, case):
    """chip_smoke.py's random tables at the tiling's edges: 1e-12 x max-abs
    against the plain version, and the same bits from two calls."""
    from chip_smoke import random_exchange_inputs

    nang, nprim, nelem, S, no = EXCHANGE_EDGES[case]
    no = _largest_no(nprim) if no == "max" else no
    args = random_exchange_inputs(cuda_device, nang=nang, nprim=nprim, nelem=nelem, nlm=S,
                                  no=no, dense_channels=S, seed=19)[name][0]
    out = getattr(kernels, name)(*args)
    again = getattr(kernels, name)(*args)
    torch.cuda.synchronize()
    ref = getattr(kernels, name + "_plain")(*args)
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.parametrize("nprim, largest", [(2, 106), (8, 102), (15, 34), (32, 14)])
def test_exchange_plan_raises_past_shared_memory(nprim, largest):
    """The occupied-orbital wrapper's shared-memory plan: the largest no it
    admits at nprim, and the ValueError naming the limit one column later."""
    from helfem_tpu_torch.kernels.radial_exchange_dia import _SMEM, _inelem_plan

    assert _largest_no(nprim) == largest
    assert _inelem_plan("radial_exchange_dia_occ", nprim, largest)[1] <= _SMEM
    with pytest.raises(ValueError, match=f"no={largest + 1} .* nprim={nprim} need"):
        _inelem_plan("radial_exchange_dia_occ", nprim, largest + 1)


@pytest.mark.parametrize("nprim, no", [(2, 250), (8, 103), (15, 48), (32, 40)])
def test_exchange_column_chunks_cover_wide_occupations(nprim, no):
    """Past the widest occupied width one launch takes (106, 102, 34, 14 at
    these nprim), the occupied-orbital wrapper splits the columns into the
    fewest contiguous chunks of near-equal width, each admitted by the plan;
    at or below it, one chunk."""
    from helfem_tpu_torch.kernels.radial_exchange_dia import _column_chunks, _inelem_plan

    name = "radial_exchange_dia_occ"
    largest = _largest_no(nprim)
    assert no > largest
    chunks = _column_chunks(name, nprim, no)
    assert chunks[0][0] == 0 and chunks[-1][1] == no
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert len(chunks) == -(-no // largest)
    widths = [b - a for a, b in chunks]
    assert max(widths) - min(widths) <= 1
    for w in set(widths):
        _inelem_plan(name, nprim, w)
    assert _column_chunks(name, nprim, largest) == [(0, largest)]


def test_exchange_plan_at_lmax12_and_channel_groups():
    """Three stages and two window buffers at the N2 lmax=12 shapes (np 15,
    no 9); the channel groups stay within the channels and 512 MiB of
    partial sums."""
    from helfem_tpu_torch.kernels.radial_exchange_dia import _channel_groups, _inelem_plan

    tm, smem, ns, wbuf = _inelem_plan("radial_exchange_dia_occ", 15, 9)
    assert (tm, ns, wbuf) == (4, 3, 2)
    for S, nang, nelem, nprim in ((125, 59, 5, 15), (42, 19, 5, 8), (1, 9, 3, 8)):
        G = _channel_groups(S, nang, nelem, nprim, tm, smem, 132)
        assert 1 <= G <= S and 16 * G * nelem * (nang * nprim) ** 2 <= 2**29


# (m, n, k): the n = 2048 and 4096 squares of chip_smoke.py (K = 4096 is
# where one accumulator's truncation shows), m != n != k shapes that a wrong
# stride or a transposition would fail, the smallest k (one ragged 32-deep
# TF32 k-tile) and a ragged last k-tile after whole ones
PROBE_SHAPES = [(2048, 2048, 2048), (4096, 4096, 4096), (384, 256, 1024), (128, 640, 16),
                (256, 384, 4096), (256, 256, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["full", "reduced"])
@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=["x".join(map(str, s)) for s in PROBE_SHAPES])
@pytest.mark.parametrize("name", ["matmul_f32", "matmul_dd"])
def test_matmul_probe_matches_plain_on_card(cuda_device, name, shape, precision):
    """1e-5 x max-abs: kernel and plain version are both f32 sums over K,
    in different orders (the plain version runs torch.matmul with
    torch.backends.cuda.matmul.allow_tf32 False, on TF32-rounded inputs for
    "reduced")."""
    m, n, k = shape
    rng = np.random.default_rng(0)
    a64 = torch.tensor(rng.standard_normal((m, k)), device=cuda_device)
    b64 = torch.tensor(rng.standard_normal((k, n)), device=cuda_device)
    args = ((a64.float(), b64.float()) if name == "matmul_f32"
            else (*split_dd(a64), *split_dd(b64)))
    before = kernels.launches[name]
    out = getattr(kernels, name)(*args, precision)
    again = getattr(kernels, name)(*args, precision)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    ref = getattr(kernels, name + "_plain")(*args, precision)
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    with pytest.raises(ValueError, match="multiples"):
        getattr(kernels, name)(*(x[:100, :100].contiguous() for x in args), precision)


@pytest.mark.cuda
def test_matmul_probe_plan_matches_kernel_smem(cuda_device):
    """The wrapper's plan asks for the shared memory the kernel launches with."""
    from helfem_tpu_torch.kernels import _build
    from helfem_tpu_torch.kernels.matmul_probe import _plan

    lib = _build.lib()
    for precision in ("full", "reduced"):
        for dd in (False, True):
            assert _plan(128, 128, 16, precision, dd)["smem"] == \
                lib.matmul_probe_smem(int(precision == "reduced"), int(dd))


@pytest.mark.parametrize("precision", ["full", "reduced"])
def test_matmul_probe_plan_covers_tile_shapes(precision):
    """Every shape TILE admits gets a launch within the card's 227 KB of
    shared memory, whose grid covers m x n and whose k-tiles cover k."""
    from helfem_tpu_torch.kernels.matmul_probe import TILE, _plan

    smem_limit = 232448  # bytes one block may have on the H100 (227 KB)

    for dd in (False, True):
        for m, n, k in ((128, 128, 16), (384, 256, 1024), (128, 640, 16), (256, 256, 48),
                        (4096, 4096, 4096), (65535 * 128, 128, 32)):
            p = _plan(m, n, k, precision, dd)
            assert p["smem"] <= smem_limit and p["threads"] in (256, 384)
            assert (p["grid"][0] * TILE[1], p["grid"][1] * TILE[0]) == (n, m)
            assert 0 <= -k % p["ktile"] < p["ktile"] and p["ktile"] % TILE[2] == 0


@pytest.mark.parametrize("shape", [(0, 128, 16), (100, 128, 16), (128, 200, 16), (128, 128, 8),
                                   (128, 128, 0), (65536 * 128, 128, 16)])
def test_matmul_probe_plan_raises_where_the_kernel_would_refuse(shape):
    from helfem_tpu_torch.kernels.matmul_probe import _plan

    for precision in ("full", "reduced"):
        with pytest.raises(ValueError):
            _plan(*shape, precision, False)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["HF", "PBE0"])
def test_dia_hf_scf_on_card_matches_cpu(cuda_device, method):
    cfg = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
    cpu = scf_diatomic(DiatomicBasis(**cfg), 7, 7, method=method, convthr=1e-9, device="cpu")
    before = dict(kernels.launches)
    gpu = scf_diatomic(DiatomicBasis(**cfg), 7, 7, method=method, convthr=1e-9,
                       device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9 and abs(gpu.Exx - cpu.Exx) < 1e-9
    assert kernels.launches["radial_exchange_dia_occ"] > before["radial_exchange_dia_occ"]
    assert kernels.launches["radial_exchange_dia"] == before["radial_exchange_dia"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["o2_uhf", "o2_uks_pbe", "o2_rohf", "h2_cation"])
def test_dia_open_shell_scf_on_card_matches_cpu(cuda_device, case):
    """The open-shell diatomic SCF on the card: the CPU's energy within 1e-9
    Eh and its iteration count; per iteration K3 once (on Pa + Pb), K6 once
    per spin that has electrons (twice for O2 UHF and ROHF, once for H2+,
    whose beta has none), K4 and K5 once for both spins (UKS)."""
    cfg, na, nb, kw = {
        "o2_uhf": (dict(Z1=8, Z2=8, Rbond=2.282, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5),
                   9, 7, dict(method="HF", restricted=0)),
        "o2_uks_pbe": (dict(Z1=8, Z2=8, Rbond=2.282, lmax=(2, 2), rmax=15.0, nelem=3,
                            nnodes=5), 9, 7, dict(method="PBE")),
        "o2_rohf": (dict(Z1=8, Z2=8, Rbond=2.282, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5),
                    9, 7, dict(method="HF", restricted=1)),
        "h2_cation": (dict(Z1=1, Z2=1, Rbond=2.0, lmax=(4,), rmax=15.0, nelem=3, nnodes=6),
                      1, 0, dict(method="HF")),
    }[case]
    cpu = scf_diatomic(DiatomicBasis(**cfg), na, nb, convthr=1e-9, device="cpu", **kw)
    kernels.reset_launches()
    gpu = scf_diatomic(DiatomicBasis(**cfg), na, nb, convthr=1e-9, device=cuda_device, **kw)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9 and gpu.niter == cpu.niter
    n, hf = gpu.niter, kw["method"] == "HF"
    assert kernels.launches["radial_coulomb_dia"] == n
    assert kernels.launches["radial_exchange_dia_occ"] == (n * ((na > 0) + (nb > 0)) if hf
                                                           else 0)
    assert kernels.launches["dia_xc_fields"] == kernels.launches["dia_xc_fock"] == (
        0 if hf else n)
    assert kernels.launches["radial_exchange_dia"] == 0


@pytest.mark.cuda
def test_two_spin_exchange_kernels_on_card(cuda_device):
    """The unrestricted SAD Fock build's stacked K1 call (both spins' cubes
    as 2 nl channels, one launch) against two one-spin calls, and K6 on a
    spin's own occupied columns against its plain version; a spin with no
    column launches nothing."""
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.models.diatomic import exchange_dia_occ

    basis = sadatom.SadAtomBasis(**SAD_SHAPES["kr_gensap"])
    ops = basis.build_ops(cuda_device)
    rng = np.random.default_rng(73)
    Pa, Pb = (torch.tensor(np.einsum("lik,ljk->lij", X, X), device=cuda_device) for X in
              rng.standard_normal((2, basis.lmax + 1, basis.nrad, 4)))
    before = kernels.launches["radial_exchange"]
    both = sadatom.sad_exchange(ops, torch.stack((Pa, Pb)))
    torch.cuda.synchronize()
    assert kernels.launches["radial_exchange"] == before + 1
    for s, P in enumerate((Pa, Pb)):
        one = sadatom.sad_exchange(ops, P)
        assert float((both[s] - one).abs().max()) <= TOL * float(one.abs().max())
    cfg = dict(Z1=8, Z2=8, Rbond=2.282, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
    dops = DiatomicBasis(**cfg).build_operators(cuda_device)
    Cob = torch.tensor(rng.standard_normal((dops.S.shape[0], 7)), device=cuda_device)
    args = (*exchange_factors(dops, Cob), dops.teiJ3, dops.dP0, dops.dP2, dops.dQ0, dops.dQ2,
            dops.step_ilm, dops.gidx)
    got = kernels.radial_exchange_dia_occ(*args)
    ref = kernels.radial_exchange_dia_occ_plain(*args)
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())
    before = kernels.launches["radial_exchange_dia_occ"]
    K = exchange_dia_occ(dops, Cob[:, :0])
    assert kernels.launches["radial_exchange_dia_occ"] == before and not K.any()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["HF", "PBE"])
def test_unrestricted_sad_on_card_matches_cpu(cuda_device, method):
    """The unrestricted SAD solve on the card: the CPU's energy within 1e-9
    Eh; per Fock build K2 once, K1 once for both spins (HF), K4 and K5
    once for both spins (PBE)."""
    from helfem_tpu_torch.models import sadatom

    cfg = dict(Z=7, lmax=1, nelem=6, nnodes=8)
    cpu = sadatom.solve_sadatom_unrestricted(sadatom.SadAtomBasis(**cfg), 5, 2, method=method,
                                             convthr=1e-9, device="cpu")
    kernels.reset_launches()
    gpu = sadatom.solve_sadatom_unrestricted(sadatom.SadAtomBasis(**cfg), 5, 2, method=method,
                                             convthr=1e-9, device=cuda_device)
    assert gpu.converged and abs(gpu.E - cpu.E) < 1e-9
    n, hf = gpu.nfock, method == "HF"
    assert kernels.launches["radial_coulomb"] == n
    assert kernels.launches["radial_exchange"] == (n if hf else 0)
    assert kernels.launches["dia_xc_fields"] == kernels.launches["dia_xc_fock"] == (
        0 if hf else n)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("seed", ["near", "rotated"])
@pytest.mark.parametrize("shape", [(4, 139), (6, 140)], ids=["ar", "n2"])
def test_refine_eig_kernel_matches_plain_on_card(cuda_device, shape, seed, groups):
    """K11 at the Ar and N2 bench block shapes (chip_smoke.py's inputs), one
    and two spins, from a near seed (accepted) and a rotated one
    (rejected): the same certificate decisions, E and V within TOL x max-abs of the plain version, the
    residuals within TOL x max|E|, one launch per call and the same bits
    twice."""
    import chip_smoke as cs

    nblk, n = shape
    A, V0 = cs.refine_inputs(nblk * groups, n, cuda_device, 67, (seed,) * groups)
    args = (A, V0, 3, 1e-9, groups)
    before = kernels.launches["refine_eig"]
    out, again = kernels.refine_eig(*args), kernels.refine_eig(*args)
    torch.cuda.synchronize()
    assert kernels.launches["refine_eig"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    ref = kernels.refine_eig_plain(*args)
    for got, want in zip(out[:2], ref[:2]):
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert float((out[2] - ref[2]).abs().max()) <= TOL * float(ref[0].abs().max())
    good = (out[2] < cs.REFINE_GATE).tolist()
    assert good == (ref[2] < cs.REFINE_GATE).tolist() == [seed == "near"] * groups


@pytest.mark.cuda
def test_refine_eig_kernel_propagates_nan_on_card(cuda_device):
    """A NaN in one off-diagonal pair of A reaches K11's outputs as it
    reaches the plain version's: the same NaN entries in E, V and the
    residual (a NaN residual fails the certificate). K11's clip of C passes
    NaN, as torch.clamp does."""
    n = 16
    A = torch.diag(torch.arange(1.0, n + 1, dtype=torch.float64, device=cuda_device))[None]
    A[0, 0, 1] = A[0, 1, 0] = float("nan")
    V0 = torch.eye(n, dtype=torch.float64, device=cuda_device)[None]
    out = kernels.refine_eig(A, V0, 3, 1e-9, 1)
    ref = kernels.refine_eig_plain(A, V0, 3, 1e-9, 1)
    for got, want in zip(out, ref):
        assert torch.equal(got.isnan(), want.isnan())
    assert bool(out[2].isnan().all()) and not bool(out[2] < 1e-9)
