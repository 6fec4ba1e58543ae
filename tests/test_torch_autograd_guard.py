"""The kernel wrappers and autograd.  The hand-written kernels have no
backward, so on a card (and on ``meta`` tensors, which run every card
check) each of the six wrappers (the paged one also in its tile mode,
which returns (o, lse)) raises ``ops.NoBackwardError`` before
any launch when grad mode is on and any floating input requires grad;
under ``torch.no_grad()`` it runs as before.  CPU tensors take the plain
versions, which differentiate.  ``tests/test_torch_cuda.py`` holds the
same on the card."""

import pytest
import torch

from repro_torch.kernels import ops


def guard_cases(device):
    """(wrapper name, call, its floating inputs) for each of the six
    wrappers at a small shape every kernel has a plan for, and the paged
    wrapper's tile mode (2 of 4 pages, 2 of 4 slots)."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(device)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32).to(device)

    q, k, v = rnd(1, 8, 2, 16), rnd(1, 8, 2, 16), rnd(1, 8, 2, 16)
    qd = rnd(1, 2, 16)
    kp, vp = rnd(4, 4, 2, 16), rnd(4, 4, 2, 16)
    x5, B4, C4 = rnd(1, 1, 8, 2, 16), rnd(1, 1, 8, 16), rnd(1, 1, 8, 16)
    dt4, a_log = rnd(1, 1, 8, 2).abs(), rnd(2)
    x4, B3, C3, dt3 = rnd(1, 8, 2, 16), rnd(1, 8, 16), rnd(1, 8, 16), \
        rnd(1, 8, 2).abs()
    pre, R = rnd(1, 3, 4, 32), 0.1 * rnd(4, 2, 16, 16)
    return [
        ("flash_attention", lambda q, k, v: ops.flash_attention(q, k, v),
         [q, k, v]),
        ("decode_attention", lambda q, k, v: ops.decode_attention(
            q, k, v, i32(5)), [qd, k, v]),
        ("paged_decode_attention", lambda q, kp, vp: ops.paged_decode_attention(
            q, kp, vp, i32(0, 2).reshape(1, 2), i32(6)), [qd, kp, vp]),
        ("ssd_intra_chunk", ops.ssd_intra_chunk, [x5, B4, C4, dt4, a_log]),
        ("ssd_chunked", lambda *a: ops.ssd_chunked(*a, chunk=8),
         [x4, B3, C3, dt3, a_log]),
        ("slstm_scan", ops.slstm_scan, [pre, R]),
        ("paged_decode_attention", lambda q, kp, vp: ops.paged_decode_attention(
            q, kp, vp, i32(0, 3).reshape(1, 2), i32(7), tile=(2, 4, 2, 4)),
         [qd, kp[2:, 2:].contiguous(), vp[2:, 2:].contiguous()]),
    ]


N_CASES = 7


def _outputs(out):
    return [t for t in (out if isinstance(out, tuple) else (out,))
            for t in (t if isinstance(t, tuple) else (t,))]


@pytest.mark.parametrize("case", range(N_CASES))
def test_meta_wrapper_raises_when_an_input_requires_grad(case):
    name, fn, inputs = guard_cases("meta")[case]
    for i in range(len(inputs)):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(ops.NoBackwardError, match="no backward"):
            fn(*args)
        with torch.no_grad():
            out = fn(*args)                 # the card path's checks, no launch
        assert all(t.device.type == "meta" for t in _outputs(out))
    args = [t.clone().requires_grad_(True) for t in inputs]
    with torch.inference_mode():
        fn(*args)


@pytest.mark.parametrize("case", range(N_CASES))
def test_cpu_wrapper_differentiates_through_the_plain_version(case):
    name, fn, inputs = guard_cases("cpu")[case]
    args = [t.clone().requires_grad_(True) for t in inputs]
    out = _outputs(fn(*args))
    grads = torch.autograd.grad(sum(o.float().sum() for o in out), args,
                                allow_unused=True)
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)
