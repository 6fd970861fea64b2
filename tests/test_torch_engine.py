"""vlm_clip_tpu_torch.vlm.engine against vlm_clip_tpu.vlm.engine and the
JAX package's ``QwenVLGenerator.generate_from_ids``.

The tiny Qwen2.5-VL and requests of tests/test_engine.py (the JAX
package's random init, bridged to the port), fp32 on the CPU. Every
greedy request's tokens must equal the JAX one-shot generation's and, in
the first cases, the JAX engine's, token for token; the cases mirror the
reference's tests that need no mesh. Cancellation is the port's own: a
per-chunk cancel mask, checked on the device state it sets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import port_qwen_config, port_vision, to_torch
from test_engine import _requests, tiny_cfgs
from vlm_clip_tpu.vlm import qwen_model as QM
from vlm_clip_tpu.vlm.engine import ContinuousBatchingEngine as REngine
from vlm_clip_tpu.vlm.qwen import QwenVLGenerator as RGen
from vlm_clip_tpu.vlm.sampling import SamplingConfig as RSampling
from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine
from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
from vlm_clip_tpu_torch.vlm.sampling import SamplingConfig


class Ref:
    """Both packages' generators on one tiny model; the JAX package's
    one-shot results, each computed once."""

    def __init__(self, seed=7):
        self.cfg = tiny_cfgs()
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        self.params = {"text": QM.init_text(k1, self.cfg.text),
                       "vision": QM.init_vision(k2, self.cfg.vision)}
        self.pcfg = port_qwen_config(self.cfg)
        self.pparams = to_torch(self.params)
        self._jgen, self._memo = {}, {}

    def jgen(self, kv_bits=16):
        if kv_bits not in self._jgen:
            self._jgen[kv_bits] = RGen(self.params, self.cfg, max_len=96,
                                       dtype=jnp.float32, kv_bits=kv_bits)
        return self._jgen[kv_bits]

    def pgen(self, kv_bits=16, max_len=96):
        return QwenVLGenerator(self.pparams, self.pcfg, max_len=max_len,
                               dtype=torch.float32, kv_bits=kv_bits)

    def want(self, ids, vision, m, scfg=None, kv_bits=16):
        """JAX generate_from_ids (``scfg`` a dict of SamplingConfig
        fields)."""
        key = (ids.tobytes(), vision.patches.tobytes(), m,
               tuple(sorted((scfg or {}).items())), kv_bits)
        if key not in self._memo:
            self._memo[key] = self.jgen(kv_bits).generate_from_ids(
                ids, vision, max_new_tokens=m,
                sampling=RSampling(**scfg) if scfg else None)
        return self._memo[key]


@pytest.fixture(scope="module")
def ref():
    return Ref()


def run(ref, ids, visions, budgets, kv_bits=16, scfg=None, stream=False,
        **kw):
    """(rids, results, engine) of the port's engine on these requests."""
    eng = ContinuousBatchingEngine(
        ref.pgen(kv_bits), sampling=SamplingConfig(**scfg) if scfg else None,
        **kw)
    rids = [eng.submit(ids, port_vision(v), max_new_tokens=m, stream=stream)
            for v, m in zip(visions, budgets)]
    got = eng.flush()
    assert sorted(got) == sorted(rids)
    return rids, got, eng


def assert_matches_generate(ref, ids, visions, budgets, got, rids,
                            scfg=None, kv_bits=16):
    for rid, v, m in zip(rids, visions, budgets):
        want = ref.want(ids, v, m, scfg, kv_bits)
        assert got[rid] == want, (rid, got[rid], want)


def test_engine_matches_jax_engine_and_generate(ref):
    """5 requests through 2 slots with staggered budgets (slots reused):
    the port's tokens equal the JAX engine's and JAX generate_from_ids's."""
    ids, visions = _requests(ref.cfg, 5)
    budgets = [4, 7, 5, 6, 3]
    rids, got, _ = run(ref, ids, visions, budgets, n_slots=2, sync_steps=3,
                       refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, budgets, got, rids)
    reng = REngine(ref.jgen(), n_slots=2, sync_steps=3, refill_chunks=(2, 1))
    jrids = [reng.submit(ids, v, max_new_tokens=m)
             for v, m in zip(visions, budgets)]
    want = reng.flush()
    assert [got[r] for r in rids] == [want[r] for r in jrids]


def test_engine_int8_kv_matches_generate_int8(ref):
    """The int8 cache: install copies the scales with the rows; tokens
    equal the JAX int8 one-shot generation's (tests/test_torch_
    speculative.py holds the int8 engine against the JAX engine too)."""
    ids, visions = _requests(ref.cfg, 3, seed=31)
    rids, got, _ = run(ref, ids, visions, [5] * 3, kv_bits=8, n_slots=2,
                       sync_steps=3, refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, [5] * 3, got, rids,
                            kv_bits=8)


def test_engine_early_stop_and_refill(ref):
    """A stop token the greedy chain emits mid-generation: the engine
    trims exactly where generate does and refills the freed slot."""
    ids, visions = _requests(ref.cfg, 4, seed=23)
    probe = ref.want(ids, visions[0], 8)
    cut = next(i for i in range(1, len(probe)) if probe[i] not in probe[:i])
    scfg = {"extra_eos": (probe[cut],)}
    assert len(ref.want(ids, visions[0], 8, scfg)) == cut
    rids, got, _ = run(ref, ids, visions, [8] * 4, scfg=scfg, n_slots=2,
                       sync_steps=4, refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, [8] * 4, got, rids, scfg)


def test_engine_repetition_penalty_parity(ref):
    """Greedy with a repetition penalty: the presence table (seeded from
    the prompt, reset at each refill) reproduces generate exactly."""
    ids, visions = _requests(ref.cfg, 3, seed=5)
    scfg = {"repetition_penalty": 1.3}
    rids, got, _ = run(ref, ids, visions, [6] * 3, scfg=scfg, n_slots=2,
                       sync_steps=2, refill_chunks=(1,))
    assert_matches_generate(ref, ids, visions, [6] * 3, got, rids, scfg)


def test_engine_grouped_refill_batches_prefill(ref, monkeypatch):
    """8 same-layout requests, 4 slots, refill chunk 4: one batched
    vision + prefill per group of 4, results as singles."""
    ids, visions = _requests(ref.cfg, 8, seed=41)
    groups = []
    install = ContinuousBatchingEngine._install
    monkeypatch.setattr(ContinuousBatchingEngine, "_install",
                        lambda self, g, s: (groups.append(len(g)),
                                            install(self, g, s)))
    rids, got, _ = run(ref, ids, visions, [4] * 8, n_slots=4, sync_steps=5,
                       refill_chunks=(4, 2, 1))
    assert groups == [4, 4]
    assert_matches_generate(ref, ids, visions, [4] * 8, got, rids)


def test_engine_mixed_layout_queue(ref):
    """Two prompt layouts in one queue: groups stay within a layout and
    both finish as their one-shot generations."""
    ids_a, vis = _requests(ref.cfg, 2, seed=3)
    ids_b = np.concatenate([ids_a, np.asarray([9, 8, 7], np.int64)])
    eng = ContinuousBatchingEngine(ref.pgen(), n_slots=2, sync_steps=3,
                                   refill_chunks=(2, 1))
    pv = [port_vision(v) for v in vis]
    r = [eng.submit(ids_a, pv[0], 4), eng.submit(ids_b, pv[0], 4),
         eng.submit(ids_a, pv[1], 4), eng.submit(ids_b, pv[1], 4)]
    got = eng.flush()
    assert got[r[0]] == ref.want(ids_a, vis[0], 4)
    assert got[r[2]] == ref.want(ids_a, vis[1], 4)
    assert got[r[1]] == ref.want(ids_b, vis[0], 4)
    assert got[r[3]] == ref.want(ids_b, vis[1], 4)


def test_engine_submit_overflow_raises(ref):
    ids, visions = _requests(ref.cfg, 1)
    eng = ContinuousBatchingEngine(ref.pgen(max_len=64), n_slots=1)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(ids, port_vision(visions[0]), max_new_tokens=64)


def test_engine_fills_the_cache_to_max_len(ref):
    """A request whose prompt + budget is exactly max_len: the finished
    row's garbage steps and the drafts past its budget would write past
    the cache (the reference's scatter drops them); the tokens still
    equal generate's."""
    ids, visions = _requests(ref.cfg, 2, seed=29)
    m = 64 - len(ids)
    want = [QwenVLGenerator(ref.pparams, ref.pcfg, max_len=64,
                            dtype=torch.float32).generate_from_ids(
        ids, port_vision(v), max_new_tokens=m) for v in visions]
    assert want[0] == ref.want(ids, visions[0], m)
    for spec_k in (0, 3):
        eng = ContinuousBatchingEngine(ref.pgen(max_len=64), n_slots=2,
                                       sync_steps=4, spec_k=spec_k,
                                       refill_chunks=(2, 1))
        rids = [eng.submit(ids, port_vision(v), max_new_tokens=m)
                for v in visions]
        got = eng.flush()
        assert [got[r] for r in rids] == want, spec_k


@pytest.mark.parametrize("knob", ["pipeline", "adaptive", "stream"])
def test_engine_scheduling_does_not_change_tokens(ref, knob):
    """Pipelined dispatch, adaptive chunk lengths and the stream flag only
    schedule: tokens equal with each on and off (and generate's), and
    adaptive chunks dispatch fewer chunks (host reads) than fixed ones."""
    ids, visions = _requests(ref.cfg, 5, seed=17)
    budgets = [4, 12, 5, 9, 3]
    outs, chunks = {}, {}
    for on in (False, True):
        kw = {"n_slots": 2, "sync_steps": 2, "refill_chunks": (2, 1)}
        if knob == "stream":
            kw["stream"] = on
        else:
            kw[knob] = on
        if knob == "adaptive":
            kw["chunk_max"] = 16
        rids, got, eng = run(ref, ids, visions, budgets, **kw)
        outs[on] = [got[r] for r in rids]
        chunks[on] = eng.stats["chunks"]
    assert outs[True] == outs[False]
    if knob == "adaptive":
        assert chunks[True] < chunks[False], chunks
    assert_matches_generate(ref, ids, visions, budgets,
                            dict(zip(range(5), outs[True])), range(5))


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_pipelined_dispatch_reads_a_chunk_behind(ref, pipeline):
    """Pipelined: a chunk is read only after the next one is dispatched
    (into the other host buffer set), except where the read chunk spends
    every live budget; unpipelined: each chunk is read before the next
    one goes out. Tokens equal generate's either way."""
    ids, visions = _requests(ref.cfg, 5, seed=17)
    budgets = [4, 12, 5, 9, 3]
    eng = ContinuousBatchingEngine(ref.pgen(), n_slots=2, sync_steps=2,
                                   refill_chunks=(2, 1), pipeline=pipeline,
                                   adaptive=False)
    behind, harvest = [], eng._harvest

    def spy(pend):
        nxt = eng._pend
        behind.append(nxt is not None and nxt is not pend
                      and nxt["host"] is not pend["host"])
        return harvest(pend)

    eng._harvest = spy
    rids = [eng.submit(ids, port_vision(v), max_new_tokens=m)
            for v, m in zip(visions, budgets)]
    got = eng.flush()
    assert eng._pend is None
    if pipeline:
        assert sum(behind) >= len(behind) // 2, behind
    else:
        assert not any(behind), behind
    assert_matches_generate(ref, ids, visions, budgets, got, rids)


def test_engine_progress_streaming_visibility(ref):
    """progress(): per-live-request harvested counts, monotone, never
    over the final output; finished requests drop out; partial_tokens is
    a prefix of the final tokens."""
    ids, visions = _requests(ref.cfg, 4, seed=57)
    budgets = [6, 3, 7, 4]
    eng = ContinuousBatchingEngine(ref.pgen(), n_slots=2, sync_steps=2,
                                   refill_chunks=(2, 1))
    assert eng.progress() == {}
    rids = [eng.submit(ids, port_vision(v), max_new_tokens=m)
            for v, m in zip(visions, budgets)]
    last, partial, finished = {}, {}, {}
    saw_partial = False
    while eng.pending:
        finished.update(eng.poll())
        for rid, cnt in eng.progress().items():
            assert rid in rids and rid not in finished
            assert cnt >= last.get(rid, 0)
            last[rid] = cnt
            partial[rid] = eng.partial_tokens(rid)
            saw_partial |= 0 < cnt < budgets[rids.index(rid)]
    assert eng.progress() == {} and saw_partial
    assert sorted(finished) == sorted(rids)
    for rid, toks in partial.items():
        assert finished[rid][:len(toks)] == toks
    assert eng.partial_tokens(rids[0]) is None
    assert_matches_generate(ref, ids, visions, budgets, finished, rids)


def test_engine_cancel_queued_and_live_through_the_mask(ref):
    """cancel(): a queued request is dropped before install; a live one
    frees its slot at once and is stopped on the device by the next
    chunk's cancel mask (done, no budget left, its depth frozen); the
    freed slot is refilled; the survivors equal generate."""
    ids, visions = _requests(ref.cfg, 5, seed=71)
    budgets = [9, 9, 6, 5, 4]
    eng = ContinuousBatchingEngine(ref.pgen(), n_slots=2, sync_steps=2,
                                   refill_chunks=(2, 1), pipeline=False,
                                   adaptive=False)
    rids = [eng.submit(ids, port_vision(v), max_new_tokens=m)
            for v, m in zip(visions, budgets)]
    assert eng.cancel(rids[4])             # queued
    assert not eng.poll()                  # rids[0], rids[1] live
    slot = eng._slot_req.index(rids[1])
    depth = int(eng.lengths[slot])
    assert eng.cancel(rids[1])             # live: the mask is set
    assert not eng.cancel(rids[1])         # already gone
    assert eng._cancel[slot] and not bool(eng.done[slot])
    pend = eng._dispatch()                 # the next chunk applies it
    assert not eng._cancel.any()
    assert bool(eng.done[slot]) and int(eng.remaining[slot]) == 0
    assert int(eng.lengths[slot]) == depth
    eng._harvest(pend)
    out = eng.flush()
    assert rids[1] not in out and rids[4] not in out
    for i in (0, 2, 3):
        assert out[rids[i]] == ref.want(ids, visions[i], budgets[i]), i


def test_engine_cancel_then_refill_keeps_the_new_request(ref):
    """A slot cancelled and refilled before any chunk runs: the install
    clears the slot's cancel bit, so the new request decodes in full."""
    ids, visions = _requests(ref.cfg, 3, seed=71)
    eng = ContinuousBatchingEngine(ref.pgen(), n_slots=1, sync_steps=2,
                                   pipeline=False, adaptive=False)
    pv = [port_vision(v) for v in visions]
    a = eng.submit(ids, pv[0], max_new_tokens=9)
    eng.poll()
    assert eng.cancel(a) and eng._cancel[0]
    b = eng.submit(ids, pv[1], max_new_tokens=5)
    out = eng.flush()
    assert out == {b: ref.want(ids, visions[1], 5)}


def test_engine_mesh_is_not_ported(ref):
    """The engine's mesh is ported (tests/test_torch_model_parallel.py
    runs it across ranks); what it refuses: a mesh that is not a
    DeviceMesh, and a 'pipe' axis (as the reference does)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        ContinuousBatchingEngine(ref.pgen(), n_slots=2, mesh=object())

    class PipeMesh:
        mesh_dim_names = ("pipe", "model")

    with pytest.raises(ValueError, match="no 'pipe' axis"):
        ContinuousBatchingEngine(ref.pgen(), n_slots=2, mesh=PipeMesh())


def test_engine_sampled_is_seeded_and_inside_the_support(ref):
    """Sampled configs: one seeded generator per engine, so a seed
    repeats its chains; tokens stay in the vocabulary and budgets."""
    ids, visions = _requests(ref.cfg, 3, seed=12)
    scfg = {"do_sample": True, "temperature": 1.1, "top_k": 8,
            "top_p": 0.95, "repetition_penalty": 1.05}
    outs = []
    for _ in range(2):
        rids, got, _ = run(ref, ids, visions, [6] * 3, scfg=scfg, n_slots=2,
                           sync_steps=2, refill_chunks=(2, 1), seed=3)
        outs.append([got[r] for r in rids])
        for r in rids:
            assert 0 < len(got[r]) <= 6
            assert all(0 <= t < ref.cfg.text.vocab_size for t in got[r])
    assert outs[0] == outs[1]
