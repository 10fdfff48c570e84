"""The port's matmul probes against the JAX package's Pallas kernels.

scripts/pallas_f64_ablation.py is loaded with importlib; on the CPU its
pallas_call sites run in interpret mode by themselves. pallas_matmul_f32,
pallas_matmul_dd and split_dd are compared with the port's plain versions
(which the wrappers run on CPU tensors) at n = 256 with 128^3 tiles, within
5e-6 x max-abs of the f64 product: both sides are f32 sums over K = 256, in
different orders. The reduced-precision Pallas kernels (pmm32, pmmdd) are
closures inside scripts/perf_campaign.py:stage_pallas and cannot be
imported, and stage_pallas itself runs n = 2048, far too large for interpret
mode; the port's "reduced" plain version is therefore held to the f64
product at 2e-3 x max-abs, the accuracy class of a 10-bit-mantissa input
rounding (the TPU probe measured 2.3e-3 for its bf16 pass), and must be
worse than the full-precision one."""

import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helfem_tpu_torch import kernels
from helfem_tpu_torch.kernels import matmul_probe
from helfem_tpu_torch.tools import f64_ablation

N = 256
TILES = dict(tm=128, tn=128, tk=128)


@pytest.fixture(scope="module")
def pallas():
    path = Path(__file__).resolve().parents[1] / "scripts" / "pallas_f64_ablation.py"
    spec = importlib.util.spec_from_file_location("pallas_f64_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(path.parent))  # it imports its sibling _timing
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
    return mod


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    a64, b64 = rng.standard_normal((N, N)), rng.standard_normal((N, N))
    ref = a64 @ b64
    return a64, b64, ref, np.abs(ref).max()


def test_split_dd_matches_jax(pallas, operands):
    a64 = operands[0]
    hi, lo = matmul_probe.split_dd(torch.tensor(a64))
    jhi, jlo = pallas.split_dd(jnp.asarray(a64))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert hi.dtype == torch.float32 and lo.dtype == torch.float32
    assert np.abs(hi.double().numpy() + lo.double().numpy() - a64).max() < 1e-14


def test_matmul_f32_matches_pallas(pallas, operands):
    a64, b64, ref, scale = operands
    a32, b32 = np.float32(a64), np.float32(b64)
    want = np.asarray(pallas.pallas_matmul_f32(jnp.asarray(a32), jnp.asarray(b32), **TILES))
    got = kernels.matmul_f32(torch.tensor(a32), torch.tensor(b32)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 5e-6 * scale
    assert np.abs(got - ref).max() <= 5e-6 * scale


def test_matmul_dd_matches_pallas(pallas, operands):
    a64, b64, ref, scale = operands
    ah, al = matmul_probe.split_dd(torch.tensor(a64))
    bh, bl = matmul_probe.split_dd(torch.tensor(b64))
    want = np.asarray(pallas.pallas_matmul_dd(*(jnp.asarray(x.numpy())
                                                for x in (ah, al, bh, bl)), **TILES))
    got = kernels.matmul_dd(ah, al, bh, bl).numpy()
    assert np.abs(got - want).max() <= 5e-6 * scale
    # one f32 accumulator: nowhere near the f64 target, as the probe exists to show
    assert 1e-9 * scale < np.abs(got - ref).max() <= 5e-6 * scale


@pytest.mark.parametrize("name", ["matmul_f32", "matmul_dd"])
def test_reduced_precision_is_tf32_class(operands, name):
    a64, b64, ref, scale = operands
    if name == "matmul_f32":
        args = (torch.tensor(a64).float(), torch.tensor(b64).float())
    else:
        args = (*matmul_probe.split_dd(torch.tensor(a64)),
                *matmul_probe.split_dd(torch.tensor(b64)))
    full = np.abs(getattr(kernels, name)(*args, "full").numpy() - ref).max()
    reduced = np.abs(getattr(kernels, name)(*args, "reduced").numpy() - ref).max()
    assert full < reduced <= 2e-3 * scale


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12,
                      -(1.0 + 2.0**-11), 3.0e-5, 1.0e20], dtype=torch.float32)
    r = matmul_probe.round_tf32(x)
    assert r[0] == 1.0 and r[1] == x[1]
    assert r[2] == 1.0 + 2.0**-10  # ties away from zero
    assert r[3] == 1.0 and r[4] == -(1.0 + 2.0**-10)
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("name, bad", [
    ("matmul_f32", lambda a, b: (a.double(), b)),
    ("matmul_f32", lambda a, b: (a[:, :100].contiguous(), b[:100].contiguous())),
    ("matmul_f32", lambda a, b: (a.T, b)),
    ("matmul_f32", lambda a, b: (a, b[:64].contiguous())),
], ids=["dtype", "ragged", "strided", "mismatch"])
def test_wrapper_rejects_bad_inputs(name, bad):
    a = torch.zeros((128, 128), dtype=torch.float32)
    with pytest.raises((TypeError, ValueError)):
        getattr(kernels, name)(*bad(a, a.clone()))
    with pytest.raises(ValueError, match="precision"):
        kernels.matmul_f32(a, a, "bf16")


def test_ablation_tool_prints_one_json_line(capsys):
    out = f64_ablation.main(["128", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and json.loads(line[0]) == out
    assert out["n"] == 128 and out["f64_target_rel_err"] == 1e-12
    for prec in ("full", "reduced"):
        assert out[f"matmul_f32_{prec}_tflops"] > 0
        assert out[f"matmul_dd_{prec}_tflops_logical"] > 0
    assert out["matmul_dd_full_max_rel_err"] < 1e-5 < out["matmul_dd_reduced_max_rel_err"]
    assert out["matmul_dd_full_max_rel_err"] > out["f64_target_rel_err"]
    assert "cpu" in out["device"]
    with pytest.raises(SystemExit):
        f64_ablation.main(["100", "--device", "cpu"])
