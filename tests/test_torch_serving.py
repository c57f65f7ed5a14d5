"""The host logic the port's server copies from the JAX package, driven
through the port on CPU: crash recovery by journal replay, transfer
retries and rollback, allocation-failure recovery, prefix/embedding-cache
hits with copy-on-write, abort at every stage and stop tokens.  Greedy
outputs after a fault or a cache hit must equal the port's uninterrupted
cold run token for token, and every pool must be reclaimed."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core.budgets import Budgets
from repro_torch.core.request import SamplingParams, Stage
from repro_torch.core.simulator import DisaggConfig
from repro_torch.engine import runner as R
from repro_torch.engine.api import Engine
from repro_torch.engine.faults import FaultEvent, FaultPlan, TransferError
from repro_torch.engine.server import HydraServer
from repro_torch.models import model as M

from conftest import assert_all_reclaimed, reduced_cfg


@pytest.fixture(scope="module")
def llava():
    cfg = reduced_cfg("llava-1.5-7b")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(5))


def _server(cfg, params, disagg, **kw):
    return HydraServer(cfg, params, DisaggConfig(disagg), device="cpu", **kw)


def _workload(cfg, seed=0, n=3, prompt_len=12):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
        media = None
        if i % 2 == 0:
            media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
                     * 0.1).astype(np.float32)
        reqs.append((prompt, media))
    return reqs


def _drive(server, max_iters=2000):
    for _ in range(max_iters):
        if all(it.req.done for it in server.items.values()):
            return
        if not server.step():
            time.sleep(0.001)
    raise AssertionError("requests did not finish")


def _drive_until(server, pred, max_iters=2000):
    for _ in range(max_iters):
        if pred():
            return True
        if not server.step():
            time.sleep(0.001)
    return False


def _baseline(cfg, params, reqs, disagg=None, max_new=6, **kw):
    srv = _server(cfg, params, disagg or {"EPD": 2}, **kw)
    rids = [srv.submit(p, media=m, max_new_tokens=max_new) for p, m in reqs]
    out = srv.run()
    return [list(out[r].generated) for r in rids]


@pytest.mark.parametrize("stage", ["queued", "post_encode", "mid_prefill",
                                   "decode"])
def test_crash_recovery_bit_exact(llava, stage):
    cfg, params = llava
    reqs = _workload(cfg, seed=11, n=3, prompt_len=40)
    kw = dict(budgets=Budgets(16, 4))   # small chunks: prefill spans steps
    expected = _baseline(cfg, params, reqs, **kw)
    srv = _server(cfg, params, {"EPD": 2}, **kw)
    rids = [srv.submit(p, media=m, max_new_tokens=6) for p, m in reqs]
    r0 = srv.items[rids[0]].req
    preds = {"queued": lambda: True,
             "post_encode": lambda: r0.stage == Stage.PREFILL,
             "mid_prefill": lambda: 0 < r0.prefill_done < r0.prefill_total,
             "decode": lambda: r0.tokens_out >= 2}
    assert _drive_until(srv, preds[stage]), f"never reached {stage}"
    holder = next(i for i in srv.instances
                  if r0 in i.running or r0 in i.waiting)
    assert srv.kill_instance(holder.iid)
    _drive(srv)
    assert [list(srv.items[r].generated) for r in rids] == expected
    assert all(srv.items[r].req.finish_reason == "length" for r in rids)
    assert srv.fault_stats()["dead_instances"] == [holder.iid]
    assert_all_reclaimed(srv)


@pytest.mark.parametrize("kind", ["drop", "corrupt"])
def test_transfer_retry_succeeds(llava, kind):
    cfg, params = llava
    reqs = _workload(cfg, seed=5, n=2)
    disagg = {"E": 1, "P": 1, "D": 1}
    expected = _baseline(cfg, params, reqs, disagg, max_new=5)
    plan = FaultPlan([FaultEvent(i, kind, arg=1) for i in range(200)])
    srv = _server(cfg, params, disagg, fault_plan=plan)
    rids = [srv.submit(p, media=m, max_new_tokens=5) for p, m in reqs]
    out = srv.run()
    assert [list(out[r].generated) for r in rids] == expected
    fs = srv.fault_stats()
    assert fs["transfer_retries"] > 0 and fs["transfer_failures"] == 0
    assert_all_reclaimed(srv)


def test_migrate_rolls_back_on_corruption(llava):
    cfg, params = llava
    srv = _server(cfg, params, {"P": 1, "D": 1}, budgets=Budgets(16, 4))
    src, dst = srv.instances
    rid = srv.submit(np.arange(24, dtype=np.int32), max_new_tokens=4)
    r = srv.items[rid].req
    assert _drive_until(srv, lambda: 0 < r.prefill_done < r.prefill_total,
                        max_iters=50)
    before = src.caches.kv.gather(rid).clone()
    with pytest.raises(TransferError) as ei:
        R.migrate(rid, src.caches, dst.caches, fault="corrupt")
    assert ei.value.kind == "corrupt"
    assert torch.equal(src.caches.kv.gather(rid), before)   # source intact
    assert rid not in dst.caches.kv.tables       # destination rolled back
    srv.abort(rid)
    assert_all_reclaimed(srv)


def test_alloc_failure_recovers(llava):
    cfg, params = llava
    reqs = _workload(cfg, seed=9, n=2)
    expected = _baseline(cfg, params, reqs)
    srv = _server(cfg, params, {"EPD": 2},
                  fault_plan=FaultPlan([FaultEvent(1, "alloc", arg=2)]))
    rids = [srv.submit(p, media=m, max_new_tokens=6) for p, m in reqs]
    _drive(srv)
    assert [list(srv.items[r].generated) for r in rids] == expected
    assert srv.fault_stats()["replays"] >= 1
    assert_all_reclaimed(srv)


def test_prefix_and_image_cache_hits_match_cold_run(llava):
    """Two concurrent sharers adopt the same resident prefix capped
    mid-block; their suffix writes copy-on-write the shared tail block of
    the torch pool and both decode exactly as the cold run; the image
    skips the encode stage."""
    cfg, params = llava
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
             * 0.1).astype(np.float32)
    sp = SamplingParams(max_tokens=5)
    cold = Engine(cfg, params, DisaggConfig({"EPD": 1}), device="cpu")
    ref = cold.generate(prompt, media=media, sampling=sp).tokens()
    warm = Engine(cfg, params, DisaggConfig({"EPD": 1}), device="cpu",
                  prefix_cache=True)
    assert warm.generate(prompt, media=media, sampling=sp).tokens() == ref
    b = warm.generate(prompt, media=media, sampling=sp)
    c = warm.generate(prompt, media=media, sampling=sp)
    warm.drain()
    assert list(warm.result(b.rid).generated) == ref
    assert list(warm.result(c.rid).generated) == ref
    assert warm.result(b.rid).req.prefix_cached_tokens == 47
    stats = warm.cache_stats()
    assert stats["cow_copies"] >= 1 and stats["encode_hit_rate"] > 0
    assert_all_reclaimed(warm.server)


@pytest.mark.parametrize("stage", [Stage.ENCODE, Stage.PREFILL,
                                   Stage.DECODE])
def test_abort_frees_blocks_at_stage(llava, stage):
    cfg, params = llava
    rng = np.random.default_rng(3)
    eng = Engine(cfg, params, DisaggConfig({"E": 1, "P": 1, "D": 1}),
                 device="cpu")
    media = (rng.standard_normal((cfg.media_tokens, cfg.d_model))
             * 0.1).astype(np.float32)
    victim = eng.generate(rng.integers(0, cfg.vocab_size, 200)
                          .astype(np.int32), media=media,
                          sampling=SamplingParams(max_tokens=64))
    bystander = eng.generate(rng.integers(0, cfg.vocab_size, 6)
                             .astype(np.int32),
                             sampling=SamplingParams(max_tokens=4))
    req = eng.result(victim.rid).req
    for _ in range(200):
        if req.stage == stage:
            break
        eng.step()
    assert req.stage == stage
    assert eng.abort(victim.rid)
    assert list(victim)[-1].finish_reason == "abort"
    eng.drain()
    assert len(eng.result(bystander.rid).generated) == 4
    assert_all_reclaimed(eng.server)


def test_stop_token_early_exit(llava):
    cfg, params = llava
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, 8) \
        .astype(np.int32)
    eng = Engine(cfg, params, DisaggConfig({"EPD": 1}), device="cpu")
    full = eng.generate(prompt, sampling=SamplingParams(max_tokens=8)) \
        .tokens()
    i = next(i for i, t in enumerate(full) if t not in full[:i])
    st = eng.generate(prompt, sampling=SamplingParams(max_tokens=8,
                                                      stop=(full[i],)))
    assert st.tokens() == full[:i]
    assert eng.result(st.rid).req.finish_reason == "stop"
    assert_all_reclaimed(eng.server)
