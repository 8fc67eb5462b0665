"""The correctness check passes sound runs and fails what it must, on the CPU.

Each cell's whole run (set-up, window, the reference, the comparison) runs
in float32 at :func:`conftest.tiny_config`'s size with the card's look
skipped, once sound and once with the timed path broken underneath, for each
fault the cell can have; the control, the reference in fp8 in the
program's place, is held to each cell's limits too.
"""
import time

import numpy as np
import pytest

import harness
from conftest import tiny_cell

TRAIN = ["fdt_b32.train.ctx32", "clip_b32.train.ctx32"]
EVAL = ["fdt_b32.eval.zeroshot"]
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2 ** 31 + 5


def _run(cell, cpu):
    outcome = cell.loop.run(cell, seed=SEED, seconds=0.5, trace=False, device=cpu,
                              process_start=time.perf_counter())
    correct = all(c["value"] <= c["limit"] for c in outcome["checks"].values())
    return outcome, correct and outcome["failed"] == 0


@pytest.mark.parametrize("cell_name", TRAIN + EVAL)
def test_sound_run_is_correct(cell_name, cpu, corpus_dir):
    outcome, correct = _run(tiny_cell(cell_name), cpu)
    assert correct, outcome["checks"]
    assert all(v > 0 for v in outcome["end_to_end"].values())


def _unchanged(grads, state, params, **kwargs):
    """AdamW that leaves every parameter as it was."""


def _half_batch(loss_fn):
    def half(image_embed, text_embed, logit_scale, **kwargs):
        half = image_embed.shape[0] // 2
        return loss_fn(image_embed[:half], text_embed[:half], logit_scale, **kwargs)
    return half


# every fault a training cell can have (its batches are made on the device,
# so nothing of the program's data path is on it)
TRAIN_FAULTS = [(c, f) for c in TRAIN for f in ("state_unchanged", "half_batch")]


@pytest.mark.parametrize("cell_name, fault", TRAIN_FAULTS)
def test_broken_training_is_not_correct(cell_name, fault, cpu, corpus_dir, monkeypatch):
    from iterated_learning_for_vlm_tpu_torch.train import step

    cell = tiny_cell(cell_name)
    if fault == "state_unchanged":
        monkeypatch.setattr(step, "adamw_update", _unchanged)
    else:
        monkeypatch.setattr(step, "clip_info_nce", _half_batch(step.clip_info_nce))
    outcome, correct = _run(cell, cpu)
    assert not correct, outcome["checks"]


def _rolled(fn):
    """An encoder answer altered where it is produced: each row gets the next
    row's embedding."""
    def call(*args, **kwargs):
        return fn(*args, **kwargs).roll(1, dims=0)
    return call


@pytest.mark.parametrize("cell_name", EVAL)
@pytest.mark.parametrize("fault", ["image_answer", "classifier_answer"])
def test_broken_eval_is_not_correct(cell_name, fault, cpu, corpus_dir, monkeypatch):
    from iterated_learning_for_vlm_tpu_torch.eval import encode, zeroshot_classification

    if fault == "image_answer":
        monkeypatch.setattr(encode.TorchEncoder, "image_batch",
                            _rolled(encode.TorchEncoder.image_batch))
    else:
        build = zeroshot_classification.build_zeroshot_classifier
        monkeypatch.setattr(zeroshot_classification, "build_zeroshot_classifier",
                            lambda *a, **k: np.roll(build(*a, **k), 1, axis=1))
    outcome, correct = _run(tiny_cell(cell_name), cpu)
    assert not correct, outcome["checks"]


def _preprocess_fault(preprocess, fault):
    """The eval transform broken where it is applied: the channels in the
    wrong order, the normalisation left out, or the crop off centre."""
    from iterated_learning_for_vlm_tpu_torch.data import augment

    def call(self, pil_images):
        x = preprocess(self, pil_images)
        if fault == "channels_swapped":
            return np.ascontiguousarray(x[..., ::-1])
        if fault == "not_normalized":
            return x * augment.IMAGENET_STD + augment.IMAGENET_MEAN
        return np.roll(x, x.shape[2] // 8, axis=2)
    return call


@pytest.mark.parametrize("cell_name", EVAL)
@pytest.mark.parametrize("fault", ["channels_swapped", "not_normalized", "crop_shifted"])
def test_broken_preprocessing_is_not_correct(cell_name, fault, cpu, corpus_dir, monkeypatch):
    from iterated_learning_for_vlm_tpu_torch.eval import encode

    monkeypatch.setattr(encode.TorchEncoder, "preprocess",
                        _preprocess_fault(encode.TorchEncoder.preprocess, fault))
    outcome, correct = _run(tiny_cell(cell_name), cpu)
    assert not correct, outcome["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_float8_control_is_not_correct(cell_name, cpu, corpus_dir):
    """The reference computed as fp8 GEMMs compute it, in the program's place,
    fails the cell's limits."""
    cell = tiny_cell(cell_name)
    rows = cell.loop.calibrate(cell, 11, ["fp8"], cpu, time.perf_counter(), 0.5)
    found = {k: rows[0][k] for k in cell.limits if k in rows[0]}
    assert any(found[k] > cell.limits[k] for k in found), found


def test_nonfinite_loss_fails(cpu):
    """A step whose loss is not finite makes the run not correct."""
    cell = tiny_cell("clip_b32.train.ctx32")
    outcome, _ = _run(cell, cpu)
    outcome["failed"] = 1
    assert not harness.emit(cell, outcome, False, {"platform": "cpu"})
