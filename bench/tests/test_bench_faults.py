"""A whole run on the CPU at a small size, the look for a card skipped:
a sound program comes out ``correct``, and the timed path broken
underneath in each way the cell can fail comes out not correct.

Faults planted (the cells run on one chip, so no exchange between chips
can be left out): a decode step that returns its state unchanged; half
of the batch left out, its rows the mean of the rest; a token or an
answer altered where it is produced. The small model's sound runs read
``top_gap`` near 0.2 and its control near 3 (this file's runs), so the
limit here is 1.0; the cells' own limits come from their runs at full
size."""

import types

import pytest
import torch

import bench.run as R
from bench.core import spec as specs
from bench.tests.small import small_cell

SEED = 2 ** 33 + 5
SERVE = {"engine": {"n_slots": 4, "max_len": 768, "prefill_chunk": 64},
         "clients": 4,
         "prompt_len": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                        "min": 16, "max": 64},
         "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                        "min": 4, "max": 16},
         "check": {"min_tokens": 40}}
ENCODE = {"batch": 2, "seq_len": 64}
CELLS = {"qwen2.5-32b.exact.sharegpt48": SERVE,
         "raella-bert-large.exact.squad384": ENCODE}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, fault=None, monkeypatch=None):
    cell = small_cell(workload, CELLS[workload], top_gap=1.0)
    if fault is not None:
        base = specs.driver(cell.traffic["driver"])

        class Faulty(base.Driver):
            def setup(self):
                info = super().setup()
                fault(self)
                return info
        monkeypatch.setattr(R.specs, "driver", lambda kind, root=None:
                            types.SimpleNamespace(Driver=Faulty))
    out = R.run_cell(workload, SEED, 5.0, False, device="cpu", cell=cell)
    _, correct = R.result_line(out, False, {})
    return out, correct


def unchanged_state(drv):
    """Each decode step hands back the state it was given: no K/V
    written, no position advanced."""
    step = drv.engine._decode

    def decode(params, cfg, state, tokens, **kw):
        keep = {"caches": [{k: v.clone() for k, v in c.items()}
                           for c in state["caches"]],
                "pos": state["pos"].clone()}
        logits, _ = step(params, cfg, state, tokens, **kw)
        for c, k in zip(state["caches"], keep["caches"]):
            for name in c:
                c[name].copy_(k[name])
        return logits, {"caches": state["caches"], "pos": keep["pos"]}
    drv.engine._decode = decode


def half_batch_decode(drv):
    step = drv.engine._decode

    def decode(*a, **kw):
        logits, state = step(*a, **kw)
        n = logits.shape[0] // 2
        logits[n:] = logits[:n].mean(dim=0, keepdim=True)
        return logits, state
    drv.engine._decode = decode


def altered_token(drv):
    commit = drv.engine._commit
    V = drv.model["vocab_size"]
    seen = []

    def alter(idx, slot, tok, finished):
        seen.append(tok)
        if len(seen) % 3 == 0:
            tok = (tok + 1) % V
        commit(idx, slot, tok, finished)
    drv.engine._commit = alter


def half_batch_forward(drv):
    forward = drv._forward

    def fwd(tokens):
        logits = forward(tokens)
        n = logits.shape[0] // 2
        logits[n:] = logits[:n].mean(dim=0, keepdim=True)
        return logits
    drv._forward = fwd


def altered_answer(drv):
    forward = drv._forward

    def fwd(tokens):
        logits = forward(tokens)
        logits[:, ::5] = logits[:, ::5].roll(1, dims=-1)
        return logits
    drv._forward = fwd


@pytest.mark.parametrize("workload", list(CELLS))
def test_sound_run_is_correct(workload):
    out, correct = run(workload)
    n = out["numbers"]
    print(workload, "sound", n)
    assert correct, n
    assert n["converts_diff"] == 0 and n["spec_failures"] == 0
    assert n["top_gap"] < 0.5 and n["checked_tokens"] >= 24
    assert out["forbidden"] == []


@pytest.mark.parametrize("workload,fault", [
    ("qwen2.5-32b.exact.sharegpt48", unchanged_state),
    ("qwen2.5-32b.exact.sharegpt48", half_batch_decode),
    ("qwen2.5-32b.exact.sharegpt48", altered_token),
    ("raella-bert-large.exact.squad384", half_batch_forward),
    ("raella-bert-large.exact.squad384", altered_answer),
], ids=lambda f: getattr(f, "__name__", f))
def test_fault_is_not_correct(workload, fault, monkeypatch):
    out, correct = run(workload, fault, monkeypatch)
    print(workload, fault.__name__, out["numbers"])
    assert not correct, out["numbers"]
