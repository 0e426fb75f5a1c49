"""PyTorch port: the jax-free host side of the SSL CLI against the JAX
package's — RecordIO, ``FaceRecordDataset``, the random subset and its
cache, ``EpochSampler``, the schedules — and the port's own prefetcher,
decoder (PIL on the CPU), logging, TOML presets and checkpoint helpers.

Everything here is exact: the same bytes, indices, orders and arrays.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from lafs_cvpr2024_tpu.data import dataset as jax_dataset
from lafs_cvpr2024_tpu.data import pipeline as jax_pipeline
from lafs_cvpr2024_tpu.data import recordio as jax_recordio
from lafs_cvpr2024_tpu.ops import schedules as jax_schedules
from lafs_cvpr2024_tpu_torch.data import recordio
from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
from lafs_cvpr2024_tpu_torch.data.decode import decode_batch
from lafs_cvpr2024_tpu_torch.data.pipeline import EpochSampler, Prefetcher
from lafs_cvpr2024_tpu_torch.ops import schedules
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    PreemptionGuard,
    TrainingCheckpointer,
    load_landmark_variables,
)
from lafs_cvpr2024_tpu_torch.utils.config import (
    apply_toml_defaults,
    resolve_mlp_impl,
)
from lafs_cvpr2024_tpu_torch.utils.logging import (
    DeferredLossFetcher,
    JSONLLogger,
    MetricLogger,
    dump_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(rng, size=(24, 20)):
    img = (rng.uniform(0, 1, (*size, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def face_rec(tmp_path_factory):
    """An insightface-style ``train.rec``: record 0 carries the identity
    range, images 1..30, then one header record per identity."""
    d = tmp_path_factory.mktemp("rec")
    rng = np.random.default_rng(0)
    sizes = [4, 7, 3, 9, 7]
    n_img = sum(sizes)
    ident0 = n_img + 1
    w = recordio.IndexedRecordIOWriter(str(d / "train.idx"), str(d / "train.rec"))
    w.write_idx(0, recordio.pack(recordio.IRHeader(
        2, np.array([ident0, ident0 + len(sizes)], np.float32), 0), b""))
    key = 1
    for ident, n in enumerate(sizes):
        for _ in range(n):
            w.write_idx(key, recordio.pack(recordio.IRHeader(
                0, float(ident), key), _jpeg(rng)))
            key += 1
    start = 1
    for ident, n in enumerate(sizes):
        w.write_idx(ident0 + ident, recordio.pack(recordio.IRHeader(
            2, np.array([start, start + n], np.float32), ident0 + ident), b""))
        start += n
    w.close()
    return str(d / "train.rec")


def test_recordio_bytes_match_jax(tmp_path):
    """pack/unpack and the writer give the JAX module's bytes."""
    for hdr in (dict(flag=0, label=3.0, id=7, id2=1),
                dict(flag=2, label=np.array([5, 9], np.float32), id=0)):
        a = recordio.pack(recordio.IRHeader(**hdr), b"xyz")
        b = jax_recordio.pack(jax_recordio.IRHeader(**hdr), b"xyz")
        assert a == b
        ha, da = recordio.unpack(a)
        hb, db = jax_recordio.unpack(b)
        assert da == db == b"xyz" and ha.flag == hb.flag
        assert np.array_equal(np.asarray(ha.label), np.asarray(hb.label))
    rng = np.random.default_rng(1)
    imgs = [_jpeg(rng) for _ in range(5)]
    for mod, sub in ((recordio, "port"), (jax_recordio, "jax")):
        b = mod.RecBuilder(str(tmp_path / sub), (24, 20))
        for i, img in enumerate(imgs):
            b.add_image(img, float(i % 2))
        b.close()
    for f in ("train.rec", "train.idx", "property"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    assert recordio.read_property(str(tmp_path / "port")) == (2, 24, 20)


def test_dataset_records_labels_and_ranges_match_jax(face_rec):
    port = FaceRecordDataset(face_rec)
    ref = jax_dataset.FaceRecordDataset(face_rec, use_native=False)
    assert port.seq == ref.seq and len(port) == len(ref) == 30
    assert port.id2range == ref.id2range
    assert port.num_identities == ref.num_identities == 5
    jpegs, labels = port.fetch_batch(range(len(port)))
    got = decode_batch(jpegs, "cpu").numpy()
    for i in range(len(ref)):
        arr, label = ref[i]
        assert np.array_equal(got[i], arr)
        assert labels[i] == label and port[i][1] == label


def test_dataset_bgr_and_partition_match_jax(face_rec):
    port = FaceRecordDataset(face_rec, bgr=True, partition=0.5)
    ref = jax_dataset.FaceRecordDataset(face_rec, bgr=True, partition=0.5,
                                        use_native=False)
    assert port.seq == ref.seq and len(port) == 15
    jpegs, _ = port.fetch_batch(range(len(port)))
    got = decode_batch(jpegs, "cpu", bgr=port.bgr).numpy()
    for i in range(len(ref)):
        assert np.array_equal(got[i], ref[i][0])


@pytest.mark.parametrize("seed,frac", [(0, 0.4), (3, 1.0), (7, 0.75)])
def test_random_subset_order_and_cache_match_jax(face_rec, tmp_path, seed,
                                                 frac):
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    port = FaceRecordDataset(face_rec, random_subset=frac,
                             subset_cache_path=str(a), seed=seed)
    ref = jax_dataset.FaceRecordDataset(face_rec, random_subset=frac,
                                        subset_cache_path=str(b), seed=seed,
                                        use_native=False)
    assert port.seq == ref.seq
    assert json.loads(a.read_text()) == json.loads(b.read_text())
    # each reads the other's cache back to the same order
    again = FaceRecordDataset(face_rec, random_subset=frac,
                              subset_cache_path=str(b), seed=seed + 1)
    assert again.seq == ref.seq


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n,bs,procs", [(30, 4, 1), (31, 5, 2), (7, 3, 3),
                                        (30, 4, 4)])
def test_epoch_sampler_matches_jax(seed, n, bs, procs):
    for rank in range(procs):
        port = EpochSampler(n, bs, seed=seed, process_index=rank,
                            process_count=procs)
        ref = jax_pipeline.EpochSampler(n, bs, seed=seed, process_index=rank,
                                        process_count=procs)
        assert port.steps_per_epoch() == ref.steps_per_epoch()
        for epoch in range(3):
            assert np.array_equal(port.epoch_indices(epoch),
                                  ref.epoch_indices(epoch))


def test_schedules_match_jax():
    for args in ((5e-4 * 32 / 256, 1e-6, 4, 7, 1), (0.04, 0.4, 3, 5, 0),
                 (0.996, 1.0, 41, 2, 0), (1.0, 0.0, 2, 3, 2, 0.1)):
        assert np.array_equal(schedules.cosine_scheduler(*args),
                              jax_schedules.cosine_scheduler(*args))
    for args in ((0.07, 0.04, 30, 41), (0.07, 0.04, 30, 2), (0.04, 0.04, 0, 3)):
        assert np.array_equal(schedules.teacher_temp_schedule(*args),
                              jax_schedules.teacher_temp_schedule(*args))
    assert schedules.dino_lr_scaling(5e-4, 82, 2) == \
        jax_schedules.dino_lr_scaling(5e-4, 82, 2)


def test_prefetcher_yields_the_sampler_batches(face_rec):
    """On the CPU: each epoch's batches are the sampler's indices decoded,
    and ``start_step`` resumes mid-epoch at the same batch."""
    ds = FaceRecordDataset(face_rec)
    sampler = EpochSampler(len(ds), 4, seed=2)
    pre = Prefetcher(ds, sampler, "cpu")
    batches = list(pre.epoch(1))
    assert len(batches) == sampler.steps_per_epoch() == 7
    idx = sampler.epoch_indices(1)
    for i, (imgs, labels) in enumerate(batches):
        jpegs, want_labels = ds.fetch_batch(idx[4 * i:4 * i + 4])
        assert imgs.dtype == torch.uint8 and imgs.shape == (4, 24, 20, 3)
        assert torch.equal(imgs, decode_batch(jpegs, "cpu"))
        assert np.array_equal(labels, want_labels)
    resumed = list(pre.epoch(1, start_step=5))
    assert len(resumed) == 2
    assert torch.equal(resumed[0][0], batches[5][0])
    # a consumer that stops early leaves no producer behind
    it = pre.epoch(0)
    next(it)
    it.close()


def test_deferred_loss_fetcher_reads_late_and_stops_on_nan():
    logger = MetricLogger(print_fn=lambda *_: None)
    f = DeferredLossFetcher(logger, nan_exit=True)
    for i, v in enumerate((1.0, 2.0, 3.0)):
        f.append(i, torch.tensor(v))
    assert "loss" not in logger.meters  # nothing read before the flush
    f.maybe_flush(1, every=100)
    assert "loss" not in logger.meters
    f.flush()
    assert logger.meters["loss"].global_avg == 2.0
    assert logger.meters["loss"].count == 3
    f.append(3, torch.tensor(float("nan")))
    with pytest.raises(SystemExit, match="step 3"):
        f.flush()


def test_metric_logger_jsonl_and_config(tmp_path):
    lines = []
    logger = MetricLogger(print_fn=lines.append)
    for x in logger.log_every(range(5), 2, "hdr"):
        logger.update(loss=float(x))
    assert len(lines) == 4 and lines[0].startswith("hdr [0/5]")
    assert logger.meters["loss"].median == 2.0
    j = JSONLLogger(str(tmp_path / "log.txt"))
    j.write({"epoch": 0, "train_loss": 1.5})
    j.write({"epoch": 1, "train_loss": 1.25})
    recs = [json.loads(x) for x in (tmp_path / "log.txt").read_text().split("\n")
            if x]
    assert [r["epoch"] for r in recs] == [0, 1]
    import argparse

    dump_config(str(tmp_path / "config.txt"), argparse.Namespace(b=2, a="x"))
    text = (tmp_path / "config.txt").read_text().splitlines()
    assert text[0].startswith("sha:") and text[1:] == ["a: x", "b: 2"]


def test_toml_presets_and_mlp_impl(tmp_path):
    from lafs_cvpr2024_tpu_torch.cli.train_ssl import get_args

    args = get_args(["--config", os.path.join(ROOT, "configs/ssl_ms1m.toml"),
                     "--data-path", "d", "--output-dir", "o", "--epochs", "2"])
    assert args.batch_size_per_chip == 82 and args.device_aug
    assert args.epochs == 2 and args.heads == 11 and args.device == "cuda"
    assert tuple(args.global_crops_scale) == (0.4, 1.0)
    bad = tmp_path / "bad.toml"
    bad.write_text("[ssl]\nbatch-sise = 3\n")
    with pytest.raises(ValueError, match="batch-sise"):
        get_args(["--config", str(bad), "--data-path", "d",
                  "--output-dir", "o"])
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, default=1.0)
    (tmp_path / "t.toml").write_text("[train]\nlr = 0.5\n")
    assert apply_toml_defaults(p, ["--config", str(tmp_path / "t.toml")]).lr \
        == 0.5
    assert resolve_mlp_impl("auto", "cuda") == "fused_ln"
    assert resolve_mlp_impl("auto", "cpu") == "dense"
    assert resolve_mlp_impl("fused", "cpu") == "fused"


def test_training_checkpointer_retention_and_restore(tmp_path):
    ck = TrainingCheckpointer(str(tmp_path / "ckpt"), keep=3, keep_period=4)
    assert ck.restore("cpu") == (None, None)
    for step in range(1, 10):
        ck.save(step, {"w": torch.full((2,), float(step)), "step": step})
    assert ck.steps() == [4, 7, 8, 9]
    payload, step = ck.restore("cpu")
    assert step == 9 and payload["step"] == 9
    assert torch.equal(payload["w"], torch.full((2,), 9.0))
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]


def test_preemption_guard_flags_the_signal_and_restores_the_handler():
    """On SIGUSR1 here, so a test runner's own SIGTERM handling is left
    alone (the CLI test sends SIGTERM to a subprocess)."""
    import signal

    before = signal.getsignal(signal.SIGUSR1)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    assert not guard.should_exit(0)
    os.kill(os.getpid(), signal.SIGUSR1)
    assert guard.requested and guard.should_exit(1)
    guard.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before


def test_load_landmark_variables_from_pth(tmp_path):
    from lafs_cvpr2024_tpu_torch.train.ssl import (
        SSLConfig,
        create_landmark_provider,
    )
    from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig

    cfg = SSLConfig(model=PartFViTConfig(num_patches=36, stn_mode="small",
                                         with_land=False, loss_type="None",
                                         num_classes=0))
    base = create_landmark_provider(cfg, 0, device="cpu")
    trained = create_landmark_provider(cfg, 5, device="cpu")
    sd = {f"module.{k}": v for k, v in trained.items()}
    sd["module.transformer.x"] = torch.zeros(3)  # not the CNN's: ignored
    torch.save({"state_dict": sd}, tmp_path / "land.pth")
    got = load_landmark_variables(str(tmp_path / "land.pth"), base,
                                  log=lambda *_: None)
    assert set(got) == set(base)
    assert all(torch.equal(got[k], trained[k]) for k in base)
    del sd["module.output_layer.weight"]
    torch.save(sd, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="output_layer.weight"):
        load_landmark_variables(str(tmp_path / "partial.pth"), base)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_landmark_variables(str(tmp_path), base)
