"""vlm_clip_tpu_torch.vlm.speculative against vlm_clip_tpu.vlm.speculative,
and the port's engine with ``spec_k`` against the JAX package's greedy
generation.

The lookup and greedy acceptance take the same numpy arrays on both
sides and must agree exactly; the sampled ``verify_round`` draws from a
seeded ``torch.Generator`` (no threefry bits to match), so its emitted
marginal is held to p within the reference tests' own bound
(tests/test_speculative.py). End to end, the speculative engine's greedy
tokens equal JAX generate_from_ids's token for token (tiny model of
tests/test_engine.py, fp32 on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_engine import EOS, _requests
from test_torch_engine import Ref, assert_matches_generate, run
from vlm_clip_tpu.vlm import sampling as RS
from vlm_clip_tpu.vlm import speculative as RSp
from vlm_clip_tpu_torch.vlm import sampling as PS
from vlm_clip_tpu_torch.vlm import speculative as PSp


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# units, both packages on the same arrays
# ---------------------------------------------------------------------------

def _draft_cases():
    rng = np.random.default_rng(0)
    hist = np.pad(np.asarray([[10, 11, 12, 13, 10, 11, 20, 0],
                              [7, 7, 7, 7, 7, 7, 7, 7]]), ((0, 0), (0, 8)))
    yield hist, np.asarray([6, 4]), 3, 2
    yield np.arange(32)[None].repeat(2, 0), np.asarray([8, 1]), 4, 2
    h = np.zeros((1, 16), np.int64)
    h[0, :6] = [5, 6, 9, 5, 6, 9]
    h[0, 6:] = 99                          # stale tokens past gen_count
    yield h, np.asarray([6]), 4, 2
    for n in (1, 2, 3):                    # small alphabets: many repeats
        hist = rng.integers(0, 4, (16, 40))
        yield hist, rng.integers(0, 41, 16), 5, n


@pytest.mark.parametrize("case", range(6))
def test_ngram_draft_matches_reference(case):
    hist, g, k, n = list(_draft_cases())[case]
    want = np.asarray(jax.jit(RSp.ngram_draft, static_argnums=(2, 3))(
        jnp.asarray(hist, jnp.int32), jnp.asarray(g, jnp.int32), k, n))
    got = PSp.ngram_draft(_t(hist).long(), _t(g), k, n=n).numpy()
    np.testing.assert_array_equal(got, want)


def test_accept_greedy_matches_reference():
    rng = np.random.default_rng(1)
    draft = np.asarray([[4, 5, 6, 7], [4, 5, 6, 7], [4, 9, 6, 7]])
    preds = np.asarray([[4, 5, 6, 7, 8], [4, EOS, 6, 7, 8],
                        [4, 5, 6, 7, 8]])
    cases = [(draft, preds, (EOS,))]
    for _ in range(4):  # low-entropy drafts: long agreeing prefixes
        d = rng.integers(0, 3, (32, 5))
        p = np.where(rng.random((32, 6)) < 0.8,
                     np.pad(d, ((0, 0), (0, 1))), rng.integers(0, 3,
                                                               (32, 6)))
        cases.append((d, p, (2, 7)))
    for d, p, stops in cases:
        want = np.asarray(RSp.accept_greedy(jnp.asarray(d), jnp.asarray(p),
                                            stops))
        got = PSp.accept_greedy(_t(d), _t(p), stops).numpy()
        np.testing.assert_array_equal(got, want)
    assert PSp.accept_greedy(_t(draft), _t(preds), (EOS,)).tolist() \
        == [4, 1, 1]


@pytest.mark.parametrize("penalty", [1.0, 1.4])
def test_verify_round_greedy_matches_reference(penalty):
    """The greedy route (with and without the repetition penalty, whose
    presence evolves over the block): the same (a, cand) as the JAX
    package's on the same logits, and cand == the step-by-step argmax."""
    rng = np.random.default_rng(5)
    B, K, V = 16, 3, 11
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    draft = rng.integers(0, V, (B, K))
    x0 = rng.integers(0, V, (B,))
    stops = (V - 1,)
    scfg = RS.SamplingConfig(repetition_penalty=penalty)
    pscfg = PS.SamplingConfig(repetition_penalty=penalty)
    presence = np.zeros((B, V if penalty != 1.0 else 1), bool)
    wa, wc = RSp.verify_round(jnp.asarray(draft, jnp.int32),
                              jnp.asarray(logits), jnp.asarray(x0, jnp.int32),
                              jnp.asarray(presence), jax.random.PRNGKey(0),
                              scfg, stops)
    a, cand = PSp.verify_round(_t(draft), _t(logits), _t(x0), _t(presence),
                               None, pscfg, stops)
    np.testing.assert_array_equal(a.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(
        a.numpy(), PSp.accept_greedy(_t(draft), cand, stops).numpy())


def _mc_marginal(pscfg, rscfg, draft_tok, seed=0, rows=20000, V=8):
    """Monte-Carlo marginal of the first emitted token of verify_round
    (the reference test's setup): rows trials share one logits row and
    one draft; emitted_0 = draft_0 if accepted else cand_0. Returns
    (empirical [V], target p_0 [V] from the JAX package's warper)."""
    K = 2
    rng = np.random.default_rng(3)
    row = (rng.normal(size=(K + 1, V)) * 2.0).astype(np.float32)
    logits = torch.from_numpy(row)[None].expand(rows, K + 1, V)
    draft = torch.tensor(draft_tok)[None].expand(rows, K)
    x0 = torch.zeros(rows, dtype=torch.int64)
    presence = torch.zeros(rows, V if pscfg.needs_presence else 1,
                           dtype=torch.bool)
    gen = torch.Generator().manual_seed(seed)
    a, cand = PSp.verify_round(draft, logits, x0, presence, gen, pscfg,
                               stops=(V + 5,))
    emitted0 = torch.where(a >= 1, draft[:, 0], cand[:, 0]).numpy()
    emp = np.bincount(emitted0, minlength=V) / rows
    pres0 = np.zeros((1, V if pscfg.needs_presence else 1), bool)
    if pscfg.needs_presence:
        pres0[0, 0] = True
    target = np.asarray(jax.nn.softmax(RS.warp_logits(
        jnp.asarray(row[:1, :]), jnp.asarray(pres0), rscfg), axis=-1))[0]
    return emp, target


@pytest.mark.parametrize("kw,draft,seed", [
    ({"do_sample": True, "temperature": 0.8}, [3, 1], 0),
    ({"do_sample": True, "temperature": 1.3, "top_k": 5, "top_p": 0.9,
      "repetition_penalty": 1.25}, [2, 4], 7)])
def test_verify_round_sampled_marginal_follows_p(kw, draft, seed):
    """The emitted-token marginal equals the warped p (20k trials, the
    reference's atol 0.015); a draft that top-k/top-p mask out is never
    emitted."""
    emp, target = _mc_marginal(PS.SamplingConfig(**kw),
                               RS.SamplingConfig(**kw), draft, seed)
    np.testing.assert_allclose(emp, target, atol=0.015)
    masked = int(np.argsort(target)[0])
    if target[masked] == 0.0:
        emp2, t2 = _mc_marginal(PS.SamplingConfig(**kw),
                                RS.SamplingConfig(**kw), [masked, 1],
                                seed + 2)
        assert emp2[masked] == 0.0 and t2[masked] == 0.0


# ---------------------------------------------------------------------------
# greedy exactness end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [1, 2, 4])
def test_spec_engine_matches_generate(ref, spec_k):
    """Staggered budgets through 2 slots with refills: the speculative
    engine equals JAX generate for every request."""
    ids, visions = _requests(ref.cfg, 5)
    budgets = [4, 9, 5, 8, 3]
    rids, got, eng = run(ref, ids, visions, budgets, n_slots=2,
                         sync_steps=3, spec_k=spec_k, refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, budgets, got, rids)
    assert eng.stats["rounds"] > 0


def test_spec_engine_int8_matches_jax_spec_engine_and_generate(ref):
    """spec_k with an int8 cache: the JAX speculative engine's tokens and
    the JAX int8 one-shot generation's."""
    from vlm_clip_tpu.vlm.engine import ContinuousBatchingEngine as REngine

    ids, visions = _requests(ref.cfg, 3, seed=5)
    budgets = [6, 4, 7]
    rids, got, _ = run(ref, ids, visions, budgets, kv_bits=8, n_slots=2,
                       sync_steps=2, spec_k=3, refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, budgets, got, rids,
                            kv_bits=8)
    reng = REngine(ref.jgen(8), n_slots=2, sync_steps=2, spec_k=3,
                   refill_chunks=(2, 1))
    jr = [reng.submit(ids, v, max_new_tokens=m)
          for v, m in zip(visions, budgets)]
    want = reng.flush()
    assert [got[r] for r in rids] == [want[r] for r in jr]


def test_spec_engine_budget_exact(ref):
    """A tight budget clips mid-acceptance: exactly the budget's tokens
    (fewer on a stop), as generate gives."""
    ids, visions = _requests(ref.cfg, 2, seed=3)
    for m in (1, 2, 5):
        rids, got, _ = run(ref, ids, visions, [m, m], n_slots=2,
                           sync_steps=4, spec_k=4, refill_chunks=(2, 1))
        assert_matches_generate(ref, ids, visions, [m, m], got, rids)
        assert all(len(got[r]) <= m for r in rids)


def test_spec_engine_penalty_greedy_matches(ref):
    """Greedy with a repetition penalty: the presence set evolves over
    the verify block as it does step by step."""
    ids, visions = _requests(ref.cfg, 3, seed=8)
    scfg = {"repetition_penalty": 1.3}
    rids, got, _ = run(ref, ids, visions, [14] * 3, scfg=scfg, n_slots=2,
                       sync_steps=3, spec_k=3, refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, [14] * 3, got, rids, scfg)


def test_spec_engine_seeds_hist_with_prompt(ref):
    """Install seeds each slot's window with the prompt: gen_count starts
    at the prompt length and hist[:T] holds its ids."""
    from _torch_port import port_vision
    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine

    ids, visions = _requests(ref.cfg, 2, seed=41)
    eng = ContinuousBatchingEngine(ref.pgen(), n_slots=2, sync_steps=2,
                                   spec_k=2, refill_chunks=(2, 1))
    for v in visions:
        eng.submit(ids, port_vision(v), max_new_tokens=4)
    eng._refill()
    T = len(ids)
    assert (eng.gen_count[:2] == T).all()
    for s in range(2):
        assert eng.hist[s, :T].tolist() == list(ids)


def test_spec_engine_prompt_lookup_matches(ref):
    """A prompt whose tail repeats an earlier phrase drafts from the
    prompt; tokens still equal generate's."""
    _, visions = _requests(ref.cfg, 3, seed=42)
    ids = np.asarray([1, 2, 249] + [250] * 16 + [5, 6, 7, 8, 9, 5, 6, 7],
                     np.int64)
    rids, got, _ = run(ref, ids, visions, [6] * 3, n_slots=2, sync_steps=3,
                       spec_k=3, refill_chunks=(2, 1))
    assert_matches_generate(ref, ids, visions, [6] * 3, got, rids)


def test_spec_engine_sampled_config_runs(ref):
    """The checkpoint-style sampled config (temperature, top-k/p,
    repetition penalty) runs with spec_k and keeps budgets and the
    vocabulary."""
    ids, visions = _requests(ref.cfg, 2, seed=4)
    scfg = {"do_sample": True, "temperature": 1.2, "top_k": 6,
            "top_p": 0.95, "repetition_penalty": 1.05}
    rids, got, _ = run(ref, ids, visions, [4, 6], scfg=scfg, n_slots=1,
                       sync_steps=2, spec_k=2, seed=5)
    for r, m in zip(rids, [4, 6]):
        assert len(got[r]) <= m
        assert all(0 <= t < ref.cfg.text.vocab_size for t in got[r])
