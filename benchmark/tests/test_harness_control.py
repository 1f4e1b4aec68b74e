"""A planted lower precision and planted faults of the program each fail
the comparison: the control (the reference in fp8, in the program's
place) against the cells' limits, and whole runs with the timed path
broken underneath (a step that leaves the state unchanged, half of each
batch left out, a VEP answer altered where it is produced)."""

import torch

from tiny import run, tiny_cell
from benchmark.compare import feature_gap, judge, training_numbers


def _limits(name):
    from benchmark import harness

    return harness.find_cell(name).settings["limits"]


def test_control_fails_training():
    import tempfile

    from benchmark import harness

    cell = "v2_pretrain_131k"
    c = tiny_cell(cell)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(c, 2 ** 40 + 3, torch.device("cpu"), tmp)
        e = harness.entry_class(c.traffic["entry"])(ctx)
        e.setup()
        e.release()
        ref = e.reference()
        ctl = e.reference(lowp=True)
        nums = training_numbers(ctl, ref, e.w0)
    ok, _ = judge(nums, _limits(cell))
    assert not ok, nums


def test_control_fails_vep():
    from benchmark import harness
    import tempfile

    c = tiny_cell("v1_vep_131k")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(c, 2 ** 40 + 5, torch.device("cpu"), tmp)
        e = harness.entry_class("vep")(ctx)
        e.setup()
        e._run(4)
        nums = {"feature_gap": feature_gap(e.reference(lowp=True),
                                           e.reference())}
    ok, _ = judge(nums, _limits("v1_vep_131k"))
    assert not ok, nums


def _use_cell_limits(c):
    c.settings["limits"] = _limits(c.name)
    return c


def test_state_left_unchanged_fails(monkeypatch):
    from caduceus_tpu_torch.train import optim

    def no_update(self, grad_norm=None):
        self.count += 1

    monkeypatch.setattr(optim.Optimizer, "step", no_update)
    result, lines = run(_use_cell_limits(tiny_cell("v2_pretrain_131k")))
    assert not result["correct"], lines[-4:]


def test_half_batch_fails_pretraining(monkeypatch):
    from caduceus_tpu_torch.train import trainer

    make = trainer.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def run_half(state, batch):
            n = batch["input_ids"].shape[0] // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return run_half

    monkeypatch.setattr(trainer, "make_train_step", halved)
    c = tiny_cell("v2_pretrain_131k")
    c.traffic["micro_batch"] = 4
    result, lines = run(_use_cell_limits(c))
    assert not result["correct"], lines[-4:]


def test_altered_answer_fails_vep(monkeypatch):
    from caduceus_tpu_torch import vep

    extract = vep.extract_embeddings

    def altered(hidden, idx, *a, **k):
        out = extract(hidden, idx, *a, **k)
        out[0] = -out[0]
        return out

    monkeypatch.setattr(vep, "extract_embeddings", altered)
    c = _use_cell_limits(tiny_cell("v1_vep_131k"))
    c.settings["reference_variants"] = 40
    result, lines = run(c)
    assert not result["correct"], lines[-4:]
