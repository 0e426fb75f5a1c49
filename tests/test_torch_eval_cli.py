"""PyTorch port: the evaluation CLIs against the JAX package's, on the CPU.

One ``.pth`` (a tiny random Part-fViT: dim 128, depth 2, 36 landmarks,
MobileNetV3-small stem, 112² input, exported from JAX parameters by
``export_torch_state_dict``) goes into both packages' CLIs, in fp32:

- ``extract_embeddings`` on the ``tests/data/ssl_rec`` records and on a
  folder of its JPEGs: embeddings at cosine ≥ 1 − 1e-5 per row (fp32 in
  another summation order), identical ``names.json``;
- ``evaluate_bin`` on a ``.bin`` of 32 pairs made from the fixture's
  JPEGs: identical accuracy, spread and threshold, xnorm to 1e-5 relative;
- ``evaluate_ijb`` on the mini IJB fixture (``tests/data/ijb_mini``): an
  identical TPR@FPR table. The JAX side runs ``--no-native``: its C++
  plane warps in float32, the port (as the numpy ``norm_crop``) in
  float64.

Equal accuracies and tables are expected, not just close ones: a distance
or a score off by 1e-6 rarely crosses a 0.01 threshold or swaps two pairs.
Where one does on these inputs, the assertion prints by how much.
"""

import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lafs_cvpr2024_tpu.cli import evaluate_bin as jax_bin
from lafs_cvpr2024_tpu.cli import evaluate_ijb as jax_ijb
from lafs_cvpr2024_tpu.cli import extract_embeddings as jax_extract
from lafs_cvpr2024_tpu.eval import ijb as jax_ijb_eval
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train.checkpoint import (
    export_torch_state_dict,
    save_torch_state_dict,
)
from lafs_cvpr2024_tpu_torch.cli import evaluate_bin, evaluate_ijb
from lafs_cvpr2024_tpu_torch.cli import extract_embeddings
from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = os.path.join(ROOT, "tests", "data", "ssl_rec")
IJB = os.path.join(ROOT, "tests", "data", "ijb_mini")
ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=112, stn_mode="small",
            loss_type="None", num_classes=0)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    model = JaxPartFViT(JaxConfig(**ARCH))
    v = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 112, 112, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    path = str(tmp_path_factory.mktemp("eval") / "model.pth")
    save_torch_state_dict(
        export_torch_state_dict(v["params"], v["batch_stats"]), path)
    return path


def fixture_jpegs(n: int = 64):
    ds = FaceRecordDataset(os.path.join(REC, "train.rec"))
    return ds.fetch_batch(range(n))


def make_bin(path: str):
    """32 pairs of the fixture's faces (8 identities of 8): even pairs from
    one identity, odd pairs from two; some entries as uint8 arrays, as
    ``.bin`` pickles may hold them."""
    jpegs, labels = fixture_jpegs()
    bins, issame = [], []
    for k in range(32):
        a, b = 2 * k, (2 * k + 1 if k % 2 == 0 else (2 * k + 9) % 64)
        bins += [jpegs[a], np.frombuffer(jpegs[b], np.uint8) if k % 5 == 0
                 else jpegs[b]]
        issame.append(bool(labels[a] == labels[b]))
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return issame


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return (a * b).sum(1)


@pytest.mark.parametrize("source", ["records", "folder"])
def test_extract_embeddings_matches_jax(pth, tmp_path, source):
    if source == "records":
        inp = REC
    else:  # the fixture's first 20 faces as files in two subfolders
        inp = str(tmp_path / "crops")
        jpegs, _ = fixture_jpegs(20)
        for i, b in enumerate(jpegs):
            os.makedirs(os.path.join(inp, f"id{i % 2}"), exist_ok=True)
            with open(os.path.join(inp, f"id{i % 2}", f"{i:03d}.jpg"),
                      "wb") as f:
                f.write(b)
    common = ["--checkpoint", pth, "--input", inp, "--batch-size", "32",
              "--eval-dtype", "float32"]
    jax_extract.main([*common, "--output", str(tmp_path / "jax")])
    extract_embeddings.main([*common, "--output", str(tmp_path / "port"),
                             "--device", "cpu"])
    out = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "names.json") as f:
            out[side] = (np.load(tmp_path / side / "embeddings.npy"),
                         json.load(f))
    (ej, nj), (ep, np_) = out["jax"], out["port"]
    assert np_ == nj and len(nj) == (64 if source == "records" else 20)
    assert ep.shape == ej.shape == (len(nj), 128) and ep.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(ep, axis=1), 1.0, rtol=1e-5)
    assert _cos(ep, ej).min() >= 1 - 1e-5


def test_extract_embeddings_refuses_what_it_cannot_decode(pth, tmp_path):
    jpegs, _ = fixture_jpegs(1)
    small = tmp_path / "small"
    small.mkdir()
    buf = io.BytesIO()
    Image.open(io.BytesIO(jpegs[0])).resize((96, 96)).save(buf, "JPEG")
    (small / "a.jpg").write_bytes(buf.getvalue())
    png = tmp_path / "png"
    png.mkdir()
    Image.open(io.BytesIO(jpegs[0])).save(png / "b.png")
    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "c.jpg").write_bytes(b"\x89PNG not a jpeg")
    for folder, match in ((small, "a.jpg is 96x96, not 112x112"),
                          (png, "b.png .*PNG and BMP"),
                          (fake, "c.jpg: not decodable")):
        with pytest.raises(ValueError, match=match):
            extract_embeddings.main(["--checkpoint", pth, "--input",
                                     str(folder), "--output",
                                     str(tmp_path / "o"), "--device", "cpu"])


def test_eval_clis_default_to_the_card(pth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    for main, argv in (
            (extract_embeddings.main, ["--checkpoint", pth, "--input", REC,
                                       "--output", str(tmp_path)]),
            (evaluate_bin.main, ["--checkpoint", pth, "--eval-path",
                                 str(tmp_path)]),
            (evaluate_ijb.main, ["--model-checkpoint", pth, "--image-path",
                                 IJB, "--meta-path", IJB])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_evaluate_bin_matches_jax(pth, tmp_path):
    issame = make_bin(str(tmp_path / "pairs.bin"))
    assert 0 < sum(issame) < len(issame)
    common = ["--checkpoint", pth, "--eval-path", str(tmp_path),
              "--targets", "pairs", "--batch-size", "32", "--nrof-folds", "4"]
    want = jax_bin.main([*common, "--json", str(tmp_path / "jax.json")])
    got = evaluate_bin.main([*common, "--json", str(tmp_path / "port.json"),
                             "--device", "cpu"])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    g, w = got["pairs"], want["pairs"]
    assert np.isfinite(g["accuracy"])
    for key in ("accuracy", "accuracy_std", "best_threshold"):
        assert g[key] == w[key], (key, g[key], w[key])
    np.testing.assert_allclose(g["xnorm"], w["xnorm"], rtol=1e-5)


def test_evaluate_ijb_matches_jax(pth, capsys, monkeypatch):
    """The table, and the [orig | flip] features each CLI hands to
    ``run_ijb_protocol`` (cosine ≥ 1 − 1e-5 per row and half)."""
    feats = {}

    def capture(side, protocol):
        def run(f, *args, **kw):
            feats[side] = f
            return protocol(f, *args, **kw)
        return run

    # the JAX CLI imports it from its eval module when main() runs
    monkeypatch.setattr(jax_ijb_eval, "run_ijb_protocol", capture(
        "jax", jax_ijb_eval.run_ijb_protocol))
    monkeypatch.setattr(evaluate_ijb, "run_ijb_protocol", capture(
        "port", evaluate_ijb.run_ijb_protocol))
    common = ["--model-checkpoint", pth, "--image-path",
              os.path.join(IJB, "loose_crop"), "--meta-path",
              os.path.join(IJB, "meta"), "--batch-size", "24",
              "--eval-dtype", "float32"]
    want = jax_ijb.main([*common, "--no-native", "--workers", "2"])
    jax_out = capsys.readouterr().out
    got = evaluate_ijb.main([*common, "--device", "cpu", "--workers", "2"])
    port_out = capsys.readouterr().out
    assert all(np.isfinite(v) for v in got.values())
    diff = {k: got[k] - want[k] for k in want if got[k] != want[k]}
    assert set(got) == set(want) and not diff, f"TPR differs by {diff}"
    table = [line for line in port_out.splitlines() if "TPR=" in line]
    assert table == [line for line in jax_out.splitlines() if "TPR=" in line]
    assert len(table) == 6
    fp, fj = feats["port"], feats["jax"]
    assert fp.shape == fj.shape == (24, 256)
    for half in (slice(0, 128), slice(128, 256)):
        assert _cos(fp[:, half], fj[:, half]).min() >= 1 - 1e-5
