"""PyTorch port: the program's spans and counters (``utils/tracing.py``) on
the CPU.

- Off (the default), the SSL step, a ``Prefetcher`` epoch and a server
  round trip make no record, with ``record_function`` and ``cuda.Event``
  made to raise: the call sites do nothing but check the flag.
- On, the step's parts nest under ``ssl.step``, the prefetcher's reading
  thread records ``input.fetch``/``input.decode`` and the consumer
  ``input.wait``, a served request's five spans share its id and the
  counters count its padded rows.
- The spans' clock is the profiler's: a span converts by the session's
  ``trace_start_ns()`` onto the profiler's interval of the op inside it.
- ``export`` carries the kernels' launch counts; the Chrome trace holds
  the program's spans beside the profiler's ops.
"""

import json
import os
import socket
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lafs_cvpr2024_tpu_torch import _build
from lafs_cvpr2024_tpu_torch.cli import serve_embeddings as srv
from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
from lafs_cvpr2024_tpu_torch.data.pipeline import EpochSampler, Prefetcher
from lafs_cvpr2024_tpu_torch.models.partfvit import (
    PartFViT,
    PartFViTConfig,
    init_random_,
)
from lafs_cvpr2024_tpu_torch.train.ssl import (
    SSLConfig,
    create_landmark_provider,
    create_ssl_state,
    make_ssl_train_step,
)
from lafs_cvpr2024_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = os.path.join(ROOT, "tests", "data", "ssl_rec", "train.rec")
ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="small",
            loss_type="None", num_classes=0)
ARGS = dict(lr=5e-4, wd=0.04, momentum=0.996, teacher_temp=0.04,
            freeze_last=1.0)
PARTS = ("ssl.multicrop", "ssl.tokens", "ssl.teacher", "ssl.student",
         "ssl.tail")
SERVE = ("serve.read", "serve.dispatch", "serve.collect.wait",
         "serve.collect.fetch", "serve.send")


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def ssl_setup():
    cfg = SSLConfig(model=PartFViTConfig(**ARCH, with_land=False),
                    compute_dtype=torch.float32, out_dim=64,
                    head_hidden_dim=96, head_bottleneck_dim=32,
                    local_crops_number=2, local_keep_landmarks=20,
                    fused_device_aug=True)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    return (create_ssl_state(cfg, 0, device="cpu"),
            create_landmark_provider(cfg, 1, device="cpu"),
            make_ssl_train_step(cfg), images)


def run_step(ssl_setup):
    state, land, step, images = ssl_setup
    new, m = step(state, land, images, None, None, None, **ARGS)
    assert np.isfinite(m["loss"].item())
    return new


def run_epoch():
    ds = FaceRecordDataset(REC)
    batches = list(Prefetcher(ds, EpochSampler(len(ds), 16, seed=1),
                              "cpu").epoch(0))
    assert len(batches) == 4
    return batches


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    pth = str(tmp_path_factory.mktemp("tracing") / "model.pth")
    model = init_random_(PartFViT(PartFViTConfig(**ARCH)), 0)
    torch.save(model.state_dict(), pth)
    return srv.EmbeddingServer(srv.get_args([
        "--checkpoint", pth, "--socket", "unused", "--batch-size", "8",
        "--image-size", "48", "--eval-dtype", "float32", "--device", "cpu"]))


def round_trip(server, sizes):
    """Requests of ``sizes`` faces over one connection, one at a time."""
    a, b = socket.socketpair()
    t = threading.Thread(target=server.handle, args=(a,), daemon=True)
    t.start()
    rng = np.random.default_rng(3)
    try:
        for n in sizes:
            imgs = rng.integers(0, 256, (n, 48, 48, 3), dtype=np.uint8)
            b.sendall(srv.EmbeddingClient._payload(imgs))
            reply = srv.EmbeddingClient._read_response(b)
            assert reply.shape == (n, 128)
    finally:
        b.close()
        t.join(timeout=60)
        a.close()
    assert not t.is_alive()


def by_name(record, name):
    return [s for s in record["spans"] if s["name"] == name]


def _raise(*a, **kw):
    raise AssertionError("called with tracing off")


@pytest.mark.parametrize("path", ["ssl_step", "prefetcher", "server"])
def test_off_makes_no_record(path, ssl_setup, server, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    {"ssl_step": lambda: run_step(ssl_setup), "prefetcher": run_epoch,
     "server": lambda: round_trip(server, [3, 11])}[path]()
    assert tracing.export() == {"spans": [], "counters": {}}


def test_ssl_step_parts_nest_under_the_step(ssl_setup):
    tracing.enable(True)
    run_step(ssl_setup)
    rec = tracing.export()
    (step,) = by_name(rec, "ssl.step")
    assert step["parent"] is None and step["ids"] == {"step": 0}
    for name in PARTS:  # host spans only: no device span off the card
        (part,) = by_name(rec, name)
        assert part["parent"] == step["id"] and part["ids"] == {"step": 0}
        assert "device_ms" not in part
        assert step["start_ns"] <= part["start_ns"] <= part["end_ns"]
        assert part["end_ns"] <= step["end_ns"]
    order = sorted(PARTS, key=lambda n: by_name(rec, n)[0]["start_ns"])
    assert order == list(PARTS)
    # the multi-crop's 2 + 2 crop pairs went through one batched chain
    assert rec["counters"]["multicrop.pairs"] == 4


def test_prefetcher_spans_sit_on_their_threads():
    tracing.enable(True)
    run_epoch()
    rec = tracing.export()
    me = threading.get_native_id()
    fetch, decode = by_name(rec, "input.fetch"), by_name(rec, "input.decode")
    wait = by_name(rec, "input.wait")
    assert [s["ids"]["batch"] for s in fetch] == [0, 1, 2, 3]
    assert [s["ids"]["batch"] for s in decode] == [0, 1, 2, 3]
    producer = {s["thread"] for s in fetch + decode}
    assert len(producer) == 1 and me not in producer
    # one ask per batch and the ask that finds the epoch's end
    assert [s["ids"]["batch"] for s in wait] == [0, 1, 2, 3, 4]
    assert {s["thread"] for s in wait} == {me}
    assert set(rec["counters"]) <= {"input.starved"}


def test_served_request_spans_share_its_id_and_count_padded_rows(server):
    tracing.enable(True)
    first = server.requests_read
    round_trip(server, [3, 11])
    rec = tracing.export()
    for name in SERVE:
        got = [s["ids"]["request"] for s in by_name(rec, name)]
        assert got == [first, first + 1], name
    for rid in (first, first + 1):
        spans = sorted((s for s in rec["spans"]
                        if s["ids"].get("request") == rid),
                       key=lambda s: s["start_ns"])
        assert [s["name"] for s in spans] == list(SERVE)
    # batch 8 with the flip: 3 faces forward 16 rows, 11 faces 32; three
    # forwards of 37 tokens, each block's attention off kernel 6's window
    assert rec["counters"] == {"serve.rows": 48, "serve.faces": 14,
                               "serve.requests": 2,
                               "attn.fused_fallback": 3 * ARCH["depth"]}


def test_padded_request_rows_per_face(server):
    tracing.enable(True)
    round_trip(server, [3])
    c = tracing.export()["counters"]
    assert (c["serve.rows"], c["serve.faces"]) == (16, 3)


def test_spans_are_on_the_profilers_clock():
    """Best of up to 20 tries: a busy host can preempt any one of them. One
    intra-op thread: on a loaded host the pool's join ends the op late."""
    x = torch.randn(128, 128)
    worst = []
    tracing.enable(True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        while len(worst) < 20 and not (worst and min(worst) <= 50.0):
            tracing.reset()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with tracing.span("clock.probe"):
                    torch.mm(x, x)
            base = prof.profiler.kineto_results.trace_start_ns()
            (mine,) = tracing.export()["spans"]
            ev = {e.name: e for e in prof.events()}
            assert ev["clock.probe"].is_user_annotation  # the same name
            op = ev["aten::mm"].time_range
            start, end = ((mine[k] - base) / 1e3
                          for k in ("start_ns", "end_ns"))
            worst.append(max(abs(start - op.start), abs(end - op.end)))
    finally:
        torch.set_num_threads(threads)
    assert min(worst) <= 50.0, worst  # µs


def test_counters_spans_ids_and_launches(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", Counter(patch_gather=5))
    tracing.enable(True)
    tracing.reset()
    _build.LAUNCHES["patch_gather"] += 2
    _build.LAUNCHES["fused_ln_mlp"] += 1
    tracing.count("a")
    tracing.count("a", 4)
    with tracing.span("outer", request=7):
        with tracing.span("inner"):
            pass
    assert tracing.device_span("d", "cpu") is tracing._NULL
    rec = tracing.export()
    assert rec["counters"] == {"a": 5, "launch.patch_gather": 2,
                               "launch.fused_ln_mlp": 1}
    inner, outer = rec["spans"]  # in the order they ended
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["id"] and outer["ids"] == {"request": 7}
    tracing.enable(False)
    tracing.count("a")
    with tracing.span("later"):
        pass
    assert tracing.export() == rec
    tracing.reset()
    assert tracing.export() == {"spans": [], "counters": {}}


def test_chrome_trace_holds_spans_and_profiler_ops(tmp_path):
    x = torch.randn(64, 64)
    tracing.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ssl.step", step=3):
            torch.mm(x, x)
    tracing.count("serve.rows", 16)
    path = tmp_path / "trace.json"
    tracing.write_chrome_trace(path, tracing.export(), prof)
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    (step,) = [e for e in ev if e["cat"] == "program"]
    assert step["name"] == "ssl.step" and step["args"]["step"] == 3
    (mm,) = [e for e in ev if e["name"] == "aten::mm"]
    assert mm["cat"] == "op"
    assert step["ts"] - 50 <= mm["ts"] <= mm["ts"] + mm["dur"] <= (
        step["ts"] + step["dur"] + 50)
    assert not [e for e in ev if e["cat"] == "op" and e["name"] == "ssl.step"]
    assert doc["otherData"]["counters"] == {"serve.rows": 16}
