"""The port's host-dispatched pipeline (``parallel/pipeline_schedule.py``,
the stage link, ``parallel/pipeline_lm.py``'s host stages) against the
JAX package's.

* The schedule functions return what the JAX ones return, integer for
  integer, over a grid of ``(stage, S, M)`` (interleaved included), and
  ``simulate_links`` raises on the same deadlock and tag reorder.
* ``pipeline.stage_stall`` and ``hang_action`` behave as the JAX site.
* The solo executor (``num_stages=1``) matches an inline data-parallel
  reference and the JAX ``HostPipelineStep`` on the same weights, at the
  JAX test's limits (``tests/test_pipeline_schedule.py``); two stages
  over a gloo world of 2 match solo, GPipe order lands bitwise on 1F1B's,
  uneven depths ``(2, 1)`` match solo, and a debug link's tag mismatch
  raises on both ends. One world of 2 runs every multi-stage case.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.parallel import pipeline_schedule as jps
from pytorch_distributed_tpu.parallel.pipeline_lm import (
    GPT2HostStagePrograms as JaxPrograms,
    host_merge_stage_params as jax_host_merge_stage_params,
    host_stage_params as jax_host_stage_params,
)
from pytorch_distributed_tpu.runtime.precision import (
    Policy as JaxPolicy,
    use_policy,
)
from pytorch_distributed_tpu_torch import optim
from pytorch_distributed_tpu_torch.interop import (
    gpt2_params_from_jax,
    gpt2_params_to_jax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import GPT2LMHead
from pytorch_distributed_tpu_torch.parallel import pipeline_schedule as ps
from pytorch_distributed_tpu_torch.parallel.pipeline_lm import (
    GPT2HostStagePrograms,
    host_merge_stage_params,
    host_stage_depths,
    host_stage_params,
)
from pytorch_distributed_tpu_torch.runtime import faults
from pytorch_distributed_tpu_torch.runtime.precision import Policy
from tests import torch_dp_workers
from tests import torch_pipeline_workers as workers

F32 = JaxPolicy(compute_dtype=jnp.float32)

GRID = [(s, S, M) for S in (1, 2, 3, 4) for s in range(S)
        for M in (1, 2, 3, 4, 8)]
INTERLEAVED = [(2, 2, 2), (2, 2, 4), (2, 3, 4), (4, 2, 4), (3, 2, 6),
               (4, 3, 8)]


def _ops(program):
    return [(op.kind, op.mb, op.chunk) for op in program]


# -- the schedule functions, integer for integer ------------------------------

@pytest.mark.parametrize("name", ["schedule_1f1b", "schedule_gpipe"])
def test_schedules_equal_the_jax_ones(name):
    for s, S, M in GRID:
        got = getattr(ps, name)(s, S, M)
        want = getattr(jps, name)(s, S, M)
        assert _ops(got) == _ops(want), (name, s, S, M)
        assert ps.peak_live_microbatches(got) == \
            jps.peak_live_microbatches(want)
    for bad in ((2, 2, 4), (0, 0, 4), (0, 2, 0)):
        with pytest.raises(ValueError):
            getattr(ps, name)(*bad)


def test_interleaved_and_virtual_stages_equal_the_jax_ones():
    for world, V, M in INTERLEAVED:
        for rank in range(world):
            assert _ops(ps.schedule_interleaved(rank, world, V, M)) == _ops(
                jps.schedule_interleaved(rank, world, V, M)), (world, V, M)
            for c in range(V):
                assert ps.virtual_stage(rank, c, world) == \
                    jps.virtual_stage(rank, c, world)
    for bad, match in (((0, 2, 1, 4), "num_chunks >= 2"),
                       ((0, 2, 2, 3), "divisible")):
        with pytest.raises(ValueError, match=match):
            ps.schedule_interleaved(*bad)


def test_bubble_depths_and_slices_equal_the_jax_ones():
    for S in (1, 2, 3, 4, 8):
        for M in (1, 2, 4, 8, 16):
            for V in (1, 2, 4):
                assert ps.bubble_fraction(S, M, V) == \
                    jps.bubble_fraction(S, M, V)
    with pytest.raises(ValueError):
        ps.bubble_fraction(0, 4)
    for L, S in ((8, 2), (12, 4), (24, 2), (4, 4), (6, 3)):
        got = ps.stage_depths(L, S)
        assert got == jps.stage_depths(L, S)
        assert ps.stage_layer_slices(got) == jps.stage_layer_slices(got)
        assert host_stage_depths(L, S) == got
    for L, rates in ((8, [1.0, 0.5]), (7, [1.0, 1.0]), (24, [3, 1, 2, 2]),
                     (5, [1.0, 0.01, 0.5]), (9, [0.2, 0.7, 0.1])):
        assert ps.stage_depths(L, len(rates), rates) == jps.stage_depths(
            L, len(rates), rates), (L, rates)
    for args, match in (((7, 2), "rank_rates"), ((2, 4), "cannot fill")):
        with pytest.raises(ValueError, match=match):
            ps.stage_depths(*args)


@pytest.mark.parametrize("maker", ["schedule_1f1b", "schedule_gpipe"])
def test_link_replay_equals_the_jax_one(maker):
    for S in (1, 2, 3, 4):
        for M in (1, 2, 4, 8):
            for capacity in (1, 2):
                got = ps.simulate_links(
                    [getattr(ps, maker)(s, S, M) for s in range(S)],
                    capacity)
                want = jps.simulate_links(
                    [getattr(jps, maker)(s, S, M) for s in range(S)],
                    capacity)
                assert got == want > 0, (S, M, capacity)


def test_simulate_links_deadlock_and_tag_reorder():
    circular = [(ps.StageOp(ps.RECV_GRAD, 0), ps.StageOp(ps.BWD, 0)),
                (ps.StageOp(ps.RECV_ACT, 0), ps.StageOp(ps.FWD, 0))]
    with pytest.raises(ps.ScheduleDeadlock):
        ps.simulate_links(circular)
    reorder = [(ps.StageOp(ps.FWD, 0), ps.StageOp(ps.SEND_ACT, 0),
                ps.StageOp(ps.FWD, 1), ps.StageOp(ps.SEND_ACT, 1)),
               (ps.StageOp(ps.RECV_ACT, 1), ps.StageOp(ps.FWD, 1),
                ps.StageOp(ps.RECV_ACT, 0), ps.StageOp(ps.FWD, 0))]
    with pytest.raises(ValueError, match="fingerprint"):
        ps.simulate_links(reorder)


def _events(seed):
    """Synthetic merged-trace events of three ranks."""
    rng = np.random.default_rng(seed)
    out = []
    for rank in range(3):
        t = float(rng.integers(0, 100))
        for name in ("pipeline.fwd", "comm.send", "pipeline.bwd",
                     "comm.recv", "train.step", "pipeline.fwd"):
            dur = float(rng.integers(1, 500))
            out.append({"name": name, "ph": "X", "ts": t, "dur": dur,
                        "pid": rank})
            t += dur + float(rng.integers(0, 50))
        out.append({"name": "pipeline.fwd", "ph": "i", "ts": t,
                    "pid": rank})
    return out


def test_trace_stats_equal_the_jax_ones():
    for seed in range(3):
        events = _events(seed)
        assert ps.pipeline_trace_stats(events) == \
            jps.pipeline_trace_stats(events)


# -- the fault site -------------------------------------------------------------

def test_stage_stall_site_and_hang_action():
    assert "pipeline.stage_stall" in faults.KNOWN_SITES
    with faults.injected(
            "pipeline.stage_stall:mode=stall,seconds=0.5,match=s1.bwd.m2"):
        assert faults.hang_action("pipeline.stage_stall",
                                  "s1.bwd.m2") == ("stall", 0.5)
        assert faults.hang_action("pipeline.stage_stall",
                                  "s0.fwd.m0") is None
        # a stall site never fires through check()
        faults.check("pipeline.stage_stall", "s1.bwd.m2")
    with faults.injected("pipeline.stage_stall:count=1,match=s0.fwd.m0"):
        assert faults.hang_action("pipeline.stage_stall", "s0.fwd.m0") is None
        with pytest.raises(faults.InjectedFault):
            faults.check("pipeline.stage_stall", "s0.fwd.m0")
    with pytest.raises(ValueError, match="seconds"):
        faults.parse("pipeline.stage_stall:mode=stall,seconds=0")


# -- the executor ----------------------------------------------------------------

SMALL = dict(layers=2, hidden=16, vocab=64, n_positions=16, steps=2,
             batch=4, seq=8, microbatches=2, seed=0, lr=0.1)


def _jax_cfg(opts):
    return JaxGPT2Config(vocab_size=opts["vocab"],
                         n_positions=opts["n_positions"],
                         hidden_size=opts["hidden"],
                         num_layers=opts["layers"], num_heads=2,
                         dropout_rate=0.0)


def _jax_params(opts):
    """Seeded weights as a JAX ``GPT2LMHead`` tree (drawn by the port's
    ``init_weights``, flax's initializers' distributions, and laid out by
    ``gpt2_params_to_jax``: no JAX compile)."""
    model = GPT2LMHead(workers.gpt2_cfg(
        num_layers=opts["layers"], vocab_size=opts["vocab"],
        hidden_size=opts["hidden"], n_positions=opts["n_positions"]),
        device="cpu", policy=Policy.full())
    model.init_weights(torch.Generator().manual_seed(opts["seed"]))
    return gpt2_params_to_jax(model.state_dict(), model.config)


def _port_sd(opts):
    sd = gpt2_params_from_jax(_jax_params(opts), _jax_cfg(opts))
    return {k: v.numpy() for k, v in sd.items()}


def _jax_solo(opts):
    """The JAX ``HostPipelineStep`` at one stage, in f32 products."""
    cfg = _jax_cfg(opts)
    with use_policy(F32):
        tx = optax.sgd(opts["lr"])
        host = jps.HostPipelineStep(
            JaxPrograms(cfg, stage=0, num_stages=1), stage=0, num_stages=1,
            num_microbatches=opts["microbatches"], tx=tx)
        params, _ = jax_host_stage_params(_jax_params(opts), stage=0,
                                          num_stages=1)
        opt = host.init_opt_state(params)
        losses = []
        for b in workers.make_batches(opts["steps"], opts["batch"],
                                      opts["seq"], opts["vocab"],
                                      opts["seed"] + 1):
            params, opt, met = host.step(params, opt, b)
            losses.append(met["loss"])
    return params, losses


def _dp_reference(opts, sd):
    """The inline reference: the whole port model, each step's
    microbatches' gradients summed by autograd, scaled by 1/M, SGD."""
    model = GPT2LMHead(workers.gpt2_cfg(
        num_layers=opts["layers"], vocab_size=opts["vocab"],
        hidden_size=opts["hidden"], n_positions=opts["n_positions"]),
        device="cpu", policy=Policy.full())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    opt = optim.SGD(model, lr=opts["lr"])
    M, losses = opts["microbatches"], []
    for b in workers.make_batches(opts["steps"], opts["batch"], opts["seq"],
                                  opts["vocab"], opts["seed"] + 1):
        opt.zero_grad()
        mb_losses = []
        for ids in torch.from_numpy(b["input_ids"]).chunk(M):
            logits = model(ids)
            loss = torch.nn.functional.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                ids[:, 1:].reshape(-1).long())
            loss.backward()
            mb_losses.append(float(loss.detach()))
        for p in model.parameters():
            p.grad.mul_(1.0 / M)
        opt.step()
        losses.append(float(np.mean(mb_losses)))
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}, \
        losses


def _assert_params(got, want, what):
    assert sorted(got) == sorted(want), (what, set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-6, rtol=1e-5,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def solo():
    sd = _port_sd(SMALL)
    return sd, workers.host_run(SMALL, sd)


def test_solo_executor_matches_dp_and_the_jax_executor(solo):
    sd, got = solo
    ref_params, ref_losses = _dp_reference(SMALL, sd)
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=2e-6)
    merged = host_merge_stage_params([got["stage_params"]], (SMALL["layers"],))
    _assert_params(merged, ref_params, "vs dp")
    jax_params, jax_losses = _jax_solo(SMALL)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=2e-6)
    whole = jax_host_merge_stage_params([jax_params], (SMALL["layers"],))
    want = {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, whole), _jax_cfg(SMALL)).items()}
    _assert_params(merged, want, "vs the JAX executor")


def test_executor_refuses_what_the_jax_one_cannot_do(solo):
    sd, _ = solo
    model = GPT2LMHead(workers.gpt2_cfg(num_layers=2, hidden_size=16,
                                        vocab_size=64, n_positions=16),
                       device="cpu", policy=Policy.full())
    module, _ = host_stage_params(model, stage=0, num_stages=1)
    progs = GPT2HostStagePrograms(module, stage=0, num_stages=1)
    clipped = optim.clip_grad_norm(optim.SGD(module, lr=0.1), 1.0)
    with pytest.raises(ValueError, match="global norm"):
        ps.HostPipelineStep(progs, stage=0, num_stages=1,
                            num_microbatches=2, optimizer=clipped)
    with pytest.raises(ValueError, match="elementwise"):
        ps.HostPipelineStep(progs, stage=0, num_stages=1,
                            num_microbatches=2,
                            optimizer=optim.Adafactor(module, 1e-2))
    sgd = optim.SGD(module, lr=0.1)
    for kw, match in ((dict(schedule="zb"), "schedule"),
                      (dict(num_stages=2), "stage link")):
        with pytest.raises(ValueError, match=match):
            ps.HostPipelineStep(progs, **{"stage": 0, "num_stages": 1,
                                          "num_microbatches": 2,
                                          "optimizer": sgd, **kw})
    host = ps.HostPipelineStep(progs, stage=0, num_stages=1,
                               num_microbatches=3, optimizer=sgd)
    with pytest.raises(ValueError, match="divisible"):
        host.step({"input_ids": np.zeros((4, 8), np.int32)})


HETERO = dict(SMALL, layers=3, depths=(2, 1))


@pytest.fixture(scope="module")
def two_stages():
    sd, sd3 = _port_sd(SMALL), _port_sd(HETERO)
    cases = [
        ("1f1b", "host_run", (SMALL, sd)),
        ("gpipe", "host_run", (dict(SMALL, schedule="gpipe"), sd)),
        ("hetero", "host_run", (HETERO, sd3)),
        ("debug", "host_run", (dict(SMALL, debug=True, trace=True,
                                    delay_s=0.01), sd)),
        ("mismatch", "link_mismatch", ()),
    ]
    ranks = torch_dp_workers.spawn(workers.world, 2, cases, timeout_s=240)
    solo3 = workers.host_run(dict(HETERO, depths=(3,)), sd3)
    return ranks, solo3


def test_two_stage_1f1b_matches_solo(solo, two_stages):
    (r0, r1), _ = two_stages
    ref = solo[1]
    for case in ("1f1b", "debug"):
        # the last stage reports the losses; the first none
        assert r0[case]["losses"] == []
        np.testing.assert_allclose(r1[case]["losses"], ref["losses"],
                                   rtol=1e-6)
        merged = host_merge_stage_params(
            [r0[case]["stage_params"], r1[case]["stage_params"]],
            host_stage_depths(SMALL["layers"], 2))
        _assert_params(merged, host_merge_stage_params(
            [ref["stage_params"]], (SMALL["layers"],)), case)


def test_two_stage_gpipe_lands_bitwise_on_1f1b(two_stages):
    (r0, r1), _ = two_stages
    # the backwards fold in microbatch order in both: the same bits
    assert [r0["gpipe"]["crc"], r1["gpipe"]["crc"]] == \
        [r0["1f1b"]["crc"], r1["1f1b"]["crc"]]
    assert r1["gpipe"]["losses"] == r1["1f1b"]["losses"]


def test_uneven_depths_match_solo(two_stages):
    (r0, r1), solo3 = two_stages
    np.testing.assert_allclose(r1["hetero"]["losses"], solo3["losses"],
                               rtol=1e-6)
    merged = host_merge_stage_params(
        [r0["hetero"]["stage_params"], r1["hetero"]["stage_params"]],
        (2, 1))
    _assert_params(merged, host_merge_stage_params(
        [solo3["stage_params"]], (3,)), "depths (2, 1)")


def test_link_mismatch_raises_on_both_ends(two_stages):
    (r0, r1), _ = two_stages
    for rep in (r0["mismatch"], r1["mismatch"]):
        err = rep["mismatch_error"]
        assert err is not None and "P2P mismatch" in err, rep
        assert "act.m1.s1" in err and "act.m2.s1" in err, err


def test_trace_stats_read_the_ports_own_export(two_stages):
    (r0, r1), _ = two_stages
    docs = [r0["debug"]["trace"], r1["debug"]["trace"]]
    stats = ps.pipeline_trace_stats(docs)
    assert sorted(stats) == [0, 1]
    for rank, st in stats.items():
        assert 0.0 < st["busy_s"] <= st["window_s"], (rank, st)
        assert st["link_s"] > 0.0 and 0.0 <= st["bubble"] < 1.0, st
    names = {ev["name"] for doc in docs for ev in doc["traceEvents"]}
    assert {"pipeline.fwd", "pipeline.bwd", "comm.send",
            "comm.recv"} <= names
