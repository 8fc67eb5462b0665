"""CPU self-tests of the benchmark harness (run: python -m pytest benchmark_torch/tests)."""
import copy
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]

import harness  # noqa: E402


def tiny_config(name: str, dtype: str = "float32") -> dict:
    """``configs/<name>.json`` at a size the CPU trains in seconds: two layers
    of width 64 per tower, 32-px images of 4 patches, a 128-code codebook."""
    cfg = harness.load_json(BENCH_DIR / "configs" / f"{name}.json")
    kw = cfg["model"]["kwargs"]
    kw["dtype"] = dtype
    kw["image_encode"].update(width=64, layers=2, heads=1, patch_size=16, input_resolution=32,
                              embed_dim=64)
    kw["text_encode"].update(width=64, layers=2, heads=1, embed_dim=64)
    if "fdt" in kw:
        kw["fdt"].update(sd_num=128, sd_dim=64, raw_img_ft_dim=64, raw_txt_ft_dim=64)
    return cfg


def tiny_cell(cell_name: str, dtype: str = "float32"):
    """The cell as ``harness.resolve`` finds it, its configuration and traffic
    cut to :func:`tiny_config`, small batches and corpora; the limits are the
    cell's. Corpora go where ``corpus.CORPUS_DIR`` points (a test's tmp_path)."""
    cell = harness.resolve(cell_name)
    cell.config = tiny_config(cell.entry["config"], dtype)
    traffic = cell.traffic = copy.deepcopy(cell.traffic)
    if traffic["loop"] == "train":
        traffic.update(batch_size=8, warmup_steps=5, trace_steps=3)
        traffic["pool"].update(batches=4, context=16)
        traffic["pool"]["caption_tokens"].update(mean=8, std=3, max=16)
    if traffic["loop"] == "zeroshot":  # 80 prompts fit a batch of 96
        traffic.update(batch_size=96, classes=8, chunk_classes=4, chunk_images=96,
                       sample_images=3)
        traffic["images"].update(name="tiny_eval", count=192, width=64, height=48, grid=4)
        # the draw's codebook temperature, low enough that inputs' embeddings differ
        cell.config["model"]["kwargs"]["fdt"]["sd_temperature"] = 1.0
    return cell


@pytest.fixture
def corpus_dir(tmp_path, monkeypatch):
    import corpus

    monkeypatch.setattr(corpus, "CORPUS_DIR", tmp_path / "corpus")
    return tmp_path / "corpus"


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
