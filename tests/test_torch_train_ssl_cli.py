"""PyTorch port: the SSL pretraining CLI (``cli/train_ssl.py``) on the CPU.

A tiny Part-fViT (dim 128, depth 2, 48² crops, 2 local crops, batch 16)
trains with ``--device cpu --device-aug --attn-impl flash`` on the JPEG
fixture ``tests/data/ssl_rec`` (64 images: 4 steps an epoch), in
subprocesses:

- 2 epochs write ``config.txt``, ``log.txt`` (finite losses) and rolling
  checkpoints;
- a run stopped by SIGTERM during its first step saves that step and
  exits; run again, it resumes mid-epoch and ends with every tensor of the
  state equal (≤ 1e-6 relative) to an uninterrupted run's: each step is a
  pure function of the state, the seed, the step and its batch;
- every option that waits for a later PR raises ``NotImplementedError``,
  and the card is the default device.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu_torch.cli import train_ssl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "ssl_rec")
TINY = ["--config", os.path.join(ROOT, "configs", "ssl_ms1m.toml"),
        "--attn-impl", "flash", "--device", "cpu", "--data-path", DATA,
        "--batch-size-per-chip", "16", "--random-subset", "1.0",
        "--epochs", "2", "--warmup-epochs", "1", "--dim", "128",
        "--depth", "2", "--heads", "2", "--mlp-dim", "256",
        "--num-patches", "36", "--image-size", "48", "--stn-mode", "small",
        "--out-dim", "64", "--head-hidden-dim", "96",
        "--head-bottleneck-dim", "32", "--local-crops-number", "2",
        "--local-keep-landmarks", "20", "--saveckp-steps", "3"]


def _cmd(out):
    return [sys.executable, "-u", "-m", "lafs_cvpr2024_tpu_torch.cli.train_ssl",
            *TINY, "--output-dir", str(out)]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="2",
                PYTHONPATH=os.pathsep.join(
                    [ROOT, os.environ.get("PYTHONPATH", "")]))


def _run(out):
    proc = subprocess.run(_cmd(out), cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _final(out):
    return torch.load(os.path.join(out, "ckpt", "step_000000008.pt"),
                      weights_only=True)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    return out, _run(out)


def test_cli_trains_two_epochs_and_writes_its_files(straight):
    out, stdout = straight
    assert (out / "config.txt").read_text().count("attn_impl: flash") == 1
    lines = (out / "log.txt").read_text().splitlines()
    assert len(lines) == 2
    import json

    recs = [json.loads(x) for x in lines]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in recs)
    assert "imgs_per_s=" in stdout
    # steps 3, 4 (epoch 0), 6, 8 (epoch 1) saved; the latest 3 kept
    assert sorted(os.listdir(out / "ckpt")) == [
        "step_000000004.pt", "step_000000006.pt", "step_000000008.pt"]
    final = _final(out)
    assert final["step"] == 8 and final["opt_count"] == 8
    assert (out / "random_index.json").exists()


def test_cli_resumes_exactly_after_sigterm(straight, tmp_path):
    ref, _ = straight
    out = tmp_path / "preempted"
    proc = subprocess.Popen(_cmd(out), cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        for line in proc.stdout:
            if line.startswith("[train_ssl] start:"):
                proc.send_signal(signal.SIGTERM)  # during the first step
                break
        rest, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert "[preempt] SIGTERM: saved step 1" in rest
    assert os.listdir(out / "ckpt") == ["step_000000001.pt"]
    resumed = _run(out)
    assert "[resume] step 1: epoch 0 step 1" in resumed
    got, want = _final(out), _final(ref)
    assert got["step"] == want["step"] == 8
    for tree in ("student", "teacher", "opt_mu", "opt_nu"):
        for k, w in want[tree].items():
            g = got[tree][k].double()
            w = w.double()
            err = (g - w).abs().max() / w.abs().max().clamp_min(1e-30)
            assert err.item() <= 1e-6, (tree, k)
    assert torch.allclose(got["center"], want["center"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("flags", [
    ["--arch", "vit_small"], ["--zero1"], ["--optimizer", "sgd"],
    ["--optimizer", "lars"], ["--teacher-dtype", "bfloat16"], ["--glo-diff"],
    ["--random-coor"], ["--use-bn-in-head"], ["--slices", "2"],
    ["--profile-steps", "3"]])
def test_waiting_options_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_ssl.main([*TINY, "--output-dir", str(tmp_path), *flags])


def test_host_augmentation_raises(tmp_path):
    """Without --device-aug the CLI would need the host PIL multi-crop."""
    argv = [a for a in TINY if a != "--config"]
    argv.remove(os.path.join(ROOT, "configs", "ssl_ms1m.toml"))
    with pytest.raises(NotImplementedError, match="device-aug"):
        train_ssl.main([*argv, "--output-dir", str(tmp_path)])


def test_local_crops_scale_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="GLOBAL scale"):
        train_ssl.main([*TINY, "--output-dir", str(tmp_path),
                        "--local-crops-scale", "0.1", "0.3"])


def test_the_card_is_the_default_device(tmp_path, monkeypatch):
    argv = [a for a in TINY]
    i = argv.index("--device")
    del argv[i:i + 2]
    args = train_ssl.get_args([*argv, "--output-dir", str(tmp_path)])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ssl.main([*argv, "--output-dir", str(tmp_path)])
