"""On the card: the program's spans (``utils/profiling.clock_ns``) and the
device's traced kernels share one clock. Under the benchmark's
``profiled()`` with tracing on, span A runs a ``torch.cuda._sleep`` of
about 2 ms and synchronises, then span B does the same: each kernel's
traced interval lies inside its span, and A's kernel ends before B's
span starts, to within 50 us, five times over. Skips without a card;
``-s`` prints each round's margins (negative: outside by that much)."""

import pytest

TOL_NS = 50_000
CYCLES = 3_000_000  # about 2 ms at the H100's 1.6-2 GHz


@pytest.mark.card
def test_program_spans_hold_their_kernels():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hb.trace import Recorder, profiled
    from vlm_clip_tpu_torch.utils import profiling as P

    torch.cuda._sleep(1000)  # the first launch's set-up, untraced
    torch.cuda.synchronize()
    margins = []
    for _ in range(5):
        P.take()
        with P.tracing(), profiled(Recorder()) as h:
            for name in ("A", "B"):
                with P.annotate(name):
                    torch.cuda._sleep(CYCLES)
                    torch.cuda.synchronize()
        spans = {s[2]: (s[3], s[4]) for s in P.take()["spans"]}
        ops = [(n[:48], round(a * 1e9), round(b * 1e9))
               for n, a, b in h.summary.kernels()]
        # the profiler drops a kernel's record now and then (3 of 38
        # sessions of two sleeps on an H100): no reading, not an offset
        assert len(ops) == 2 and set(spans) == {"A", "B"}, (
            "the trace does not hold the two sleep kernels", ops, spans)
        ks = sorted(o[1:] for o in ops)
        (a0, a1), (b0, b1) = spans["A"], spans["B"]
        (ka0, ka1), (kb0, kb1) = ks
        assert ka1 - ka0 > 1_000_000  # the sleep, not a stray kernel
        m = {"A start": ka0 - a0, "A end": a1 - ka1, "B start": kb0 - b0,
             "B end": b1 - kb1, "A kernel before B span": b0 - ka1}
        margins.append(m)
        print({k: f"{v / 1e3:+.1f} us" for k, v in m.items()})
    worst = {k: min(m[k] for m in margins) for k in margins[0]}
    print("worst margins:", {k: f"{v / 1e3:+.1f} us"
                             for k, v in worst.items()})
    assert all(v >= -TOL_NS for v in worst.values()), worst
