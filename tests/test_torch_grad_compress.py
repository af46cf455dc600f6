"""Compressed gradient sync in the port (``parallel/overlap.py``,
``parallel/ddp.py``) against the JAX package's host ring.

* ``q8_local_roundtrip`` equals the JAX numpy replication bitwise, on
  random data, a ragged tail block, zero blocks and NaN/inf blocks.
* ``sync_grads(compress=k)`` over gloo against the JAX ``sync_grads``
  on its ring, the same seeded per-rank leaves (coalesced leaves under
  4096 elements, solo leaves up to a leaf longer than one 2,097,152-
  element chunk), three steps, at worlds 2 and 3: bf16 and fp16
  bitwise at world 2 and within half an ulp of their dtype at world 3
  (the port keeps the ring's segments and summation order, so it is
  bitwise there too); int8 within one final quantization step (the
  block's scale) everywhere and bitwise in at least 99% of the elements
  (the ring's owner fold is an FMA, the port's an f64 sum rounded
  once); every rank's result bitwise equal; the q8 residuals after three
  steps bitwise the JAX engine's (they are computed on each rank before
  any exchange).
* The wire bytes: bf16 and fp16 half of f32's, int8 about a quarter.

The DDP hook path is held in tests/test_torch_grad_compress_ddp.py.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.parallel.overlap import (
    q8_local_roundtrip as jax_roundtrip,
)
from pytorch_distributed_tpu_torch.parallel import overlap
from tests import torch_compress_workers as cw
from tests import torch_dp_workers as workers
from tests.hostring_workers import run_ring_workers

#: half of a half-precision ulp at the value's magnitude
HALF_ULP = {"bf16": 2.0 ** -8, "fp16": 2.0 ** -11}
Q8_EXACT_SHARE = 0.99


def _roundtrip_inputs():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(256 * 7 + 93) * 4).astype(np.float32)
    x[256:512] = 0.0                     # a zero block
    x[600] = np.nan                      # a NaN block
    x[1100] = np.inf                     # an inf block
    x[1400] = -np.inf
    x[1600:1700] *= 1e-30                # tiny values
    x[1800] = 3.0e38                     # near the f32 top
    return x


def test_q8_roundtrip_is_bitwise_the_jax_one():
    x = _roundtrip_inputs()
    want = jax_roundtrip(x)
    got = overlap.q8_local_roundtrip(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  want[ok].view(np.uint32))
    assert np.isnan(got[512:768]).all() and (got[256:512] == 0).all()
    # the codes and scales behind it
    q, s = overlap.q8_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.numel() == -(-x.size // 256)
    assert int(q.abs().max()) <= 127


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def synced(request, tmp_path_factory):
    world = request.param
    out = str(tmp_path_factory.mktemp(f"compress{world}"))
    res = run_ring_workers(world, cw.jax_sync, (out,), timeout=300)
    assert all(r[1] == "ok" for r in res), res
    wire = workers.spawn(cw.port_sync, world, out, timeout_s=300)
    load = lambda who, r: dict(np.load(f"{out}/{who}-rank{r}.npz"))  # noqa
    return (world, [load("jax", r) for r in range(world)],
            [load("port", r) for r in range(world)], wire)


@pytest.mark.parametrize("kind", cw.KINDS)
def test_sync_grads_holds_the_jax_ring(synced, kind):
    world, jax_res, port_res, _ = synced
    for step in range(cw.STEPS):
        for k in sorted(cw.LEAF_SHAPES):
            key = f"{kind}/{step}/{k}"
            got = [r[key] for r in port_res]
            for r in range(1, world):   # ranks bitwise equal
                np.testing.assert_array_equal(got[r].view(np.uint32),
                                              got[0].view(np.uint32), key)
            want = jax_res[0][key]
            g = got[0]
            if kind in HALF_ULP:
                if world == 2:
                    np.testing.assert_array_equal(g, want, key)
                else:
                    tol = HALF_ULP[kind] * np.abs(want)
                    assert np.all(np.abs(g - want) <= tol), key
                continue
            # int8: exact leaves bitwise; q8 leaves within a step of the
            # final scale, most of them bitwise
            if want.size < overlap.COALESCE_MAX_ELEMS:
                np.testing.assert_array_equal(g, want, key)
                continue
            n = want.size
            pad = (-n) % 256
            w = np.pad(want, (0, pad)).reshape(-1, 256)
            step_size = np.abs(w).max(axis=1) / 127
            diff = np.pad(np.abs(g - want), (0, pad)).reshape(-1, 256)
            assert np.all(diff <= step_size[:, None] * (1 + 1e-6)), key
            share = float(np.mean(g == want))
            assert share >= Q8_EXACT_SHARE, (key, share)


def test_q8_residuals_are_bitwise_the_jax_engines(synced):
    world, jax_res, port_res, _ = synced
    for r in range(world):
        keys = sorted(k for k in jax_res[r] if k.startswith("residual/"))
        assert keys == [f"residual/{k}" for k in ("d", "e", "f")]
        assert sorted(k for k in port_res[r]
                      if k.startswith("residual/")) == keys
        for k in keys:
            np.testing.assert_array_equal(port_res[r][k].view(np.uint32),
                                          jax_res[r][k].view(np.uint32), k)


def test_wire_bytes_shrink_with_the_wire_form(synced):
    world, _, _, wire = synced
    total = sum(int(np.prod(s)) for s in cw.LEAF_SHAPES.values())
    for per_rank in wire:
        # the halves ship 2 bytes an element twice (exchange, gather),
        # less each rank's own segment: 2 (world - 1) / world of 2 bytes
        for kind in ("bf16", "fp16"):
            want = 2 * (world - 1) / world * 2 * total * cw.STEPS
            assert abs(per_rank[kind] - want) <= 0.01 * want, per_rank
        assert per_rank["int8"] < 0.6 * per_rank["bf16"], per_rank
