"""The check's teeth, at smoke size on the CPU: the harness's run (the
look for a card skipped) with the timed path broken underneath must
come out not correct, once for each fault a serving cell can have, and
so must the control (the reference at TF32 in the program's place).
One card, so no exchange between chips exists to leave out."""

import pytest
import torch

from conftest import SEED
from portbench import harness
from portbench.reference.numerics import round_tf32


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.0 - 2 ** -9])
    got = round_tf32(x)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0,
                         -3.0 - 2 ** -9])
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["clip-b16.poisson", "internvl2-1b.chat"])
def test_the_control_is_not_correct(smoke_root, cell):
    out = harness.run(smoke_root, cell, SEED, 1.5, False, "cpu",
                      control=True)
    assert out["correct"]
    limits = {k: n["limit"] for k, n in out["checks"].items()}
    assert any(v > limits[k] for k, v in out["control"].items()), \
        (out["control"], limits)


def _token_altered(monkeypatch):
    from repro_torch.serving import decode

    select = decode.select_token
    calls = {"n": 0}

    def altered(logits, generator=None, **kw):
        calls["n"] += 1
        tok = select(logits, generator, **kw)
        return (tok + 1) % logits.shape[-1] if calls["n"] % 5 == 0 else tok

    monkeypatch.setattr(decode, "select_token", altered)


def _answer_altered(monkeypatch):
    from repro_torch.serving.engine import S2M3Engine

    apply_head = S2M3Engine.apply_head

    def altered(self, *a, **kw):
        out, used = apply_head(self, *a, **kw)
        return out + 0.01 * out.abs().max(), used

    monkeypatch.setattr(S2M3Engine, "apply_head", altered)


def _half_batch(monkeypatch):
    """A batched encoder call that computes only its first half and
    hands those rows to the rest too."""
    from repro_torch.serving.engine import S2M3Engine

    apply_module = S2M3Engine.apply_module

    def half(self, name, x, **kw):
        n = x.shape[0]
        if n < 2:
            return apply_module(self, name, x, **kw)
        out, used = apply_module(self, name, x[:(n + 1) // 2], **kw)
        idx = torch.arange(n, device=out.device) % out.shape[0]
        return out[idx], used

    monkeypatch.setattr(S2M3Engine, "apply_module", half)


def _state_unchanged(monkeypatch):
    """The decode step leaves the page pool as it found it."""
    from repro_torch.layers import attention

    monkeypatch.setattr(attention, "paged_cache_insert",
                        lambda pages, new, tables, lengths: None)


@pytest.mark.parametrize("fault,cell", [
    (_token_altered, "internvl2-1b.chat"),
    (_answer_altered, "clip-b16.poisson"),
    (_answer_altered, "internvl2-1b.short"),
    (_half_batch, "clip-b16.saturate"),
    (_half_batch, "internvl2-1b.short"),
    (_state_unchanged, "internvl2-1b.chat"),
], ids=["token-altered", "answer-altered-clip", "answer-altered-vlm",
        "half-batch-clip", "half-batch-vlm", "state-unchanged"])
def test_a_broken_timed_path_is_not_correct(smoke_root, monkeypatch, fault,
                                             cell):
    fault(monkeypatch)
    out = harness.run(smoke_root, cell, SEED + 3, 1.5, False, "cpu")
    assert not out["correct"], out["checks"]
