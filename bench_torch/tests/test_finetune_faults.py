"""The supervised finetuning cell's output check catches what a broken timed
path would produce: the runner driven on the CPU at a small size (widths,
depth, classes, batch and records cut; everything else as committed, the
limits included), with the program's step broken underneath, and
``correct`` read off the result line. The step computes in fp32 here, on
both sides of the configuration's check: the CPU's bf16 products round
otherwise than the card's, and the limits are the card's (``PERF.md``
§2)."""

import argparse
import dataclasses
import json
import time

import pytest
import torch

from bench_torch import run
from bench_torch.runners import finetune_train

SMALL = {"dim": 128, "depth": 2, "heads": 2, "dim-head": 64, "mlp-dim": 256,
         "num-patches": 36, "num-classes": 50, "batch-size": 4,
         "compute-dtype": "float32"}


@pytest.fixture(autouse=True)
def fp32_step(monkeypatch):
    config = finetune_train.supervised_config
    monkeypatch.setattr(
        finetune_train, "supervised_config",
        lambda m: dataclasses.replace(config(m), compute_dtype=torch.float32))


def small_files() -> dict:
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    files = run.cell_files(bench, "finetune_step")
    files["model"] = {**files["model"], **SMALL}
    files["traffic"] = dict(files["traffic"], rounds=1,
                            classes=SMALL["num-classes"])
    return files


def drive(tmp_path, capsys, seed=2 ** 31 + 77, seconds=2.0):
    files = small_files()
    args = argparse.Namespace(workload="finetune_step", seed=seed,
                              seconds=seconds, trace=0)
    out = finetune_train.run(args, files, tmp_path, time.perf_counter(),
                             torch.device("cpu"))
    capsys.readouterr()
    run.report(args, files, out)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_finetune_sound_run_is_correct(tmp_path, capsys):
    line = drive(tmp_path, capsys)
    assert line["correct"] and line["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_finetune_fault_is_caught(fault, tmp_path, capsys, monkeypatch):
    from lafs_cvpr2024_tpu_torch.train import supervised

    make = supervised.make_train_step

    def broken(cfg):
        step = make(cfg)

        def faulty(state, images, labels, lr):
            if fault == "half_batch":
                n = images.shape[0] // 2
                return step(state, images[:n], labels[:n], lr)
            _, metrics = step(state, images, labels, lr)
            return state, metrics

        faulty.__dict__.update(step.__dict__)
        return faulty

    monkeypatch.setattr(supervised, "make_train_step", broken)
    line = drive(tmp_path, capsys)
    assert line["correct"] is False
