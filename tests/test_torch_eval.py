"""PyTorch port: the evaluation modules against the JAX package's.

- Every numpy function of ``eval/verification.py`` and ``eval/ijb.py`` is
  a copy and must return the JAX function's values exactly (``==``) on
  seeded inputs, both branches of ``pair_scores`` included.
- ``ops/warp.py::warp_affine_batch`` repeats ``warp_affine``'s arithmetic
  (float64 coordinates and taps, float32 sums, truncation to uint8): its
  pixels must equal the numpy warp's exactly (a share of 0 pixels off, on
  random matrices and on the Umeyama fits of the mini IJB fixture); a
  degenerate matrix gives a zero image in both.
- ``load_bin`` on a ``.bin`` made here equals the JAX ``load_bin``.
- ``perform_val`` with the port's ``make_embed_fn`` against the JAX
  package's on the same weights (tiny Part-fViT, fp32, uint8 batches
  scaled inside the embed function): identical accuracy and threshold,
  xnorm within 1e-5 relative (fp32 in another summation order).
- ``load_eval_model`` builds every eval model with ``attn_impl='fused'``:
  kernel 6 (its plain version on the CPU) at 128-512 tokens in heads of
  64, the einsum path otherwise (each such block counts
  ``attn.fused_fallback`` with the tracer on, nothing with it off); either
  way the embeddings match the JAX model's (einsum attention) on the same
  ``.pth`` to cosine ≥ 1 − 1e-5.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.eval import ijb as jax_ijb
from lafs_cvpr2024_tpu.eval import verification as jax_ver
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train.checkpoint import (
    export_torch_state_dict,
    save_torch_state_dict,
)
from lafs_cvpr2024_tpu.train import supervised as jax_sup
from lafs_cvpr2024_tpu_torch import eval as port_eval
from lafs_cvpr2024_tpu_torch.data.dataset import FaceRecordDataset
from lafs_cvpr2024_tpu_torch.eval import ijb, verification
from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig
from lafs_cvpr2024_tpu_torch.ops.warp import (
    decode_warp_batch,
    warp_affine_batch,
)
from lafs_cvpr2024_tpu_torch.train import supervised
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    state_dict_from_flax,
    to_tensors,
)
from lafs_cvpr2024_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = os.path.join(ROOT, "tests", "data", "ssl_rec", "train.rec")
IJB = os.path.join(ROOT, "tests", "data", "ijb_mini")


def _same(a, b):
    """Equal values, recursively through tuples, lists and dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _embeddings(rng, n=60, d=16):
    e = rng.standard_normal((n, d))
    return e / np.linalg.norm(e, axis=1, keepdims=True)


VERIFICATION_CASES = {
    "kfold_indices": lambda r: ((23, 5), {}),
    "calculate_accuracy": lambda r: ((0.7, r.uniform(0, 2, 40),
                                      r.random(40) < 0.5), {}),
    "calculate_roc": lambda r: ((np.arange(0, 4, 0.01), _embeddings(r),
                                 _embeddings(r), r.random(60) < 0.5, 5), {}),
    "calculate_val": lambda r: ((np.arange(0, 4, 0.01), _embeddings(r),
                                 _embeddings(r), r.random(60) < 0.5, 1e-1,
                                 5), {}),
    "_val_far": lambda r: ((1.1, r.uniform(0, 2, 40), r.random(40) < 0.5),
                           {}),
    "evaluate": lambda r: ((_embeddings(r, 80), r.random(40) < 0.5, 4), {}),
    "_roc_from_dist": lambda r: ((r.uniform(0, 4, 50), r.random(50) < 0.5,
                                  np.arange(0, 4, 0.01), 5), {}),
    "evaluate_token": lambda r: ((_embeddings(r, 80), r.random(40) < 0.5, 4),
                                 {}),
    "evaluate_two": lambda r: ((_embeddings(r, 80), _embeddings(r, 80),
                                r.random(40) < 0.5, 4), {}),
}


@pytest.mark.parametrize("name", sorted(VERIFICATION_CASES))
def test_verification_numpy_functions_equal_jax(name):
    args, kw = VERIFICATION_CASES[name](np.random.default_rng(7))
    got = getattr(verification, name)(*args, **kw)
    want = getattr(jax_ver, name)(*args, **kw)
    if name == "kfold_indices":
        got, want = list(got), list(want)
    _same(got, want)
    fields = [f.name for f in dataclasses.fields(verification.
                                                 VerificationResult)]
    assert fields == [f.name for f in dataclasses.fields(
        jax_ver.VerificationResult)]


def _templates(r, n=40, t=9):
    return r.integers(0, t, n) * 3 + 1, r.integers(0, 5, n)


IJB_CASES = {
    "umeyama": lambda r: (r.uniform(20, 90, (5, 2)).astype(np.float32),
                          ijb.ARCFACE_SRC),
    "norm_crop": lambda r: (r.integers(0, 256, (90, 70, 3), np.uint8),
                            r.uniform(10, 60, (5, 2)).astype(np.float32)),
    "warp_affine": lambda r: (r.integers(0, 256, (50, 60, 3), np.uint8),
                              np.array([[0.9, 0.2, -3.0], [-0.1, 1.1, 4.5]]),
                              (40, 44)),
    "image2template_feature": lambda r: (r.standard_normal((40, 8)),
                                         *_templates(r)),
    "roc_curve": lambda r: (np.round(r.uniform(-1, 1, 200), 2),
                            r.random(200) < 0.3),
    "tpr_at_fpr_table": lambda r: (r.uniform(-1, 1, 300),
                                   r.random(300) < 0.3),
    "fuse_features": lambda r: (r.standard_normal((12, 16)),
                                r.uniform(0.5, 1, 12), ijb.IJBConfig()),
}


@pytest.mark.parametrize("name", sorted(IJB_CASES))
def test_ijb_numpy_functions_equal_jax(name):
    args = IJB_CASES[name](np.random.default_rng(11))
    _same(getattr(ijb, name)(*args), getattr(jax_ijb, name)(*args))


@pytest.mark.parametrize("use_norm,use_det,use_flip", [
    (True, True, True), (False, True, True), (True, False, False),
    (False, False, True)])
def test_ijb_protocol_equals_jax(use_norm, use_det, use_flip):
    r = np.random.default_rng(5)
    feats = r.standard_normal((40, 16))
    templates, medias = _templates(r)
    p1, p2 = r.choice(np.unique(templates), (2, 30))
    labels = (r.random(30) < 0.4).astype(int)
    face = r.uniform(0.5, 1, 40)
    kw = dict(use_norm_score=use_norm, use_detector_score=use_det,
              use_flip_test=use_flip)
    got = ijb.run_ijb_protocol(feats, templates, medias, p1, p2, labels,
                               face, ijb.IJBConfig(**kw))
    want = jax_ijb.run_ijb_protocol(feats, templates, medias, p1, p2, labels,
                                    face, jax_ijb.IJBConfig(**kw))
    assert got == want and len(got) == 6


@pytest.mark.parametrize("batch", [100000, 7])
def test_pair_scores_both_branches_equal_jax(batch):
    """t² ≤ 64n takes the gram matrix; 80 templates for 20 pairs take the
    batched gathers (in chunks of ``batch``)."""
    r = np.random.default_rng(3)
    for t, n in ((9, 30), (80, 20)):
        feats = r.standard_normal((t, 8))
        uniq = np.sort(r.choice(500, t, replace=False))
        p1, p2 = r.choice(uniq, (2, n))
        _same(ijb.pair_scores(feats, uniq, p1, p2, batch),
              jax_ijb.pair_scores(feats, uniq, p1, p2, batch))


def test_meta_readers_and_exports_equal_jax():
    meta = os.path.join(IJB, "meta")
    for fn, name in (("read_template_media_list", "ijbc_face_tid_mid.txt"),
                     ("read_template_pair_list",
                      "ijbc_template_pair_label.txt")):
        path = os.path.join(meta, name)
        _same(getattr(ijb, fn)(path), getattr(jax_ijb, fn)(path))
    from lafs_cvpr2024_tpu import eval as jax_eval

    assert sorted(port_eval.__all__) == sorted(jax_eval.__all__)
    assert ijb.IJBConfig() == ijb.IJBConfig(True, True, True)
    np.testing.assert_array_equal(ijb.ARCFACE_SRC, jax_ijb.ARCFACE_SRC)


def test_warp_affine_batch_equals_numpy_warp():
    """Random similarity and shear maps, partly outside the image, over a
    batch of one size: every pixel equal to ``warp_affine``'s (a share of 0
    pixels off); a NaN and a singular matrix give zero images, as the numpy
    warp gives for the NaN fit of a rank-0 Umeyama."""
    r = np.random.default_rng(0)
    imgs = r.integers(0, 256, (6, 70, 90, 3), np.uint8)
    mats = np.zeros((6, 2, 3))
    for i in range(4):
        a, s = r.uniform(-0.5, 0.5), r.uniform(0.6, 1.6)
        mats[i, :, :2] = s * np.array([[np.cos(a), -np.sin(a)],
                                       [np.sin(a), np.cos(a)]])
        mats[i, :, :2] += r.uniform(-0.1, 0.1, (2, 2))
        mats[i, :, 2] = r.uniform(-40, 20, 2)
    mats[4] = np.nan
    mats[5] = [[1.0, 2.0, 0.0], [2.0, 4.0, 0.0]]
    got = warp_affine_batch(torch.from_numpy(imgs), mats, (56, 64)).numpy()
    with np.errstate(invalid="ignore"):  # the NaN map's casts
        want = np.stack([jax_ijb.warp_affine(im, m, (56, 64))
                         for im, m in zip(imgs[:5], mats[:5])])
    assert got.dtype == np.uint8 and got.shape == (6, 56, 64, 3)
    assert (got[:5] != want).mean() == 0.0
    assert not got[4:].any() and not want[4].any()
    assert got[:4].any()


def test_decode_warp_batch_equals_numpy_norm_crop():
    """The mini IJB fixture (four canvas sizes, decoded with PIL on the
    CPU): the port's decode and warp equal the JAX ``norm_crop`` of each
    image, and the stored reference, exactly."""
    from PIL import Image

    names = np.loadtxt(os.path.join(IJB, "meta", "ijbc_name_5pts_score.txt"),
                       dtype=str, usecols=0)
    lms = np.loadtxt(os.path.join(IJB, "meta", "ijbc_name_5pts_score.txt"),
                     usecols=range(1, 11), dtype=np.float32).reshape(-1, 5, 2)
    jpegs = [open(os.path.join(IJB, "loose_crop", n), "rb").read()
             for n in names]
    mats = np.stack([jax_ijb.umeyama(lm, jax_ijb.ARCFACE_SRC)[:2]
                     for lm in lms])
    got = decode_warp_batch(jpegs, mats, "cpu").numpy()
    want = np.stack([jax_ijb.norm_crop(np.asarray(Image.open(
        os.path.join(IJB, "loose_crop", n)).convert("RGB")), lm)
        for n, lm in zip(names, lms)])
    ref = np.load(os.path.join(IJB, "aligned_ref.npz"))["aligned"]
    assert len({Image.open(os.path.join(IJB, "loose_crop", n)).size
                for n in names}) == 4
    assert got.shape == (24, 112, 112, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: len(ref)], ref)


def _make_bin(path, n_pairs=12):
    ds = FaceRecordDataset(REC)
    jpegs, labels = ds.fetch_batch(range(2 * n_pairs))
    bins = [np.frombuffer(b, np.uint8) if i % 3 == 0 else b
            for i, b in enumerate(jpegs)]
    issame = [bool(labels[2 * k] == labels[(2 * k + 5) % len(jpegs)])
              for k in range(n_pairs)]
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)


def test_load_bin_equals_jax(tmp_path):
    path = str(tmp_path / "v.bin")
    _make_bin(path)
    data, issame = verification.load_bin(path, device="cpu")
    want, want_same = jax_ver.load_bin(path)
    assert data.dtype == torch.uint8 and data.shape == (2, 24, 112, 112, 3)
    np.testing.assert_array_equal(data.numpy(), want)
    np.testing.assert_array_equal(issame, want_same)
    (name, d2, s2), = verification.get_val_data(str(tmp_path), ["v"], "cpu")
    assert name == "v" and torch.equal(d2, data)
    with pytest.raises(ValueError, match="not \\(96, 96\\)"):
        verification.load_bin(path, image_size=(96, 96), device="cpu")


def test_perform_val_with_make_embed_fn_equals_jax(tmp_path):
    arch = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
                num_patches=36, image_size=112, stn_mode="small",
                num_classes=10)
    jcfg = jax_sup.SupervisedConfig(model=JaxConfig(**arch))
    model = jax_sup._build_backbone(jcfg, with_head=False, eval_mode=True)
    v = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.zeros((1, 112, 112, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    path = str(tmp_path / "v.bin")
    _make_bin(path, 16)
    data, issame = jax_ver.load_bin(path)
    jax_embed = jax_sup.make_embed_fn(jcfg, input_scale="half")
    want = jax_ver.perform_val(lambda b: jax_embed(v, jnp.asarray(b)), data,
                               issame, batch_size=12, nrof_folds=4,
                               device_scale=True)

    pcfg = supervised.SupervisedConfig(model=PartFViTConfig(**arch))
    variables = to_tensors(state_dict_from_flax(v["params"],
                                                v["batch_stats"]))
    variables["loss.weight"] = torch.zeros(10, 128)  # ignored
    port_embed = supervised.make_embed_fn(pcfg, input_scale="half")
    got = verification.perform_val(
        lambda b: port_embed(variables, b), torch.from_numpy(data), issame,
        batch_size=12, nrof_folds=4, device_scale=True)
    assert got.accuracy == want.accuracy
    assert got.best_threshold == want.best_threshold
    np.testing.assert_allclose(got.xnorm, want.xnorm, rtol=1e-5)
    # host scaling (device_scale=False) gives the same embeddings
    plain_embed = supervised.make_embed_fn(pcfg)
    host = verification.perform_val(
        lambda b: plain_embed(variables, b), torch.from_numpy(data), issame,
        batch_size=12, nrof_folds=4)
    np.testing.assert_allclose(host.xnorm, got.xnorm, rtol=1e-6)
    assert host.accuracy == got.accuracy


@pytest.mark.parametrize("traced", [True, False])
@pytest.mark.parametrize("num_patches,overrides,fallbacks", [
    (143, {}, 0),             # 144 tokens in heads of 64: kernel 6
    (36, {}, 2),              # 37 tokens: the einsum path in both blocks
    (520, {}, 2),             # 521 tokens: over kernel 6's 512
    (143, {"heads": 4}, 2),   # heads of 32 (--heads 4): the einsum path
])
def test_eval_models_take_kernel_6_where_it_fits(tmp_path, num_patches,
                                                 overrides, fallbacks,
                                                 traced):
    arch = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
                num_patches=num_patches, image_size=48, stn_mode="small",
                loss_type="None", num_classes=0)
    v = jax.jit(JaxPartFViT(JaxConfig(**arch)).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 48, 48, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    path = str(tmp_path / "model.pth")
    save_torch_state_dict(
        export_torch_state_dict(v["params"], v["batch_stats"]), path)
    loaded = port_eval.load_eval_model(path, {"image_size": 48, **overrides},
                                       device="cpu", log=lambda _: None)
    cfg = loaded.cfg
    assert cfg.attn_impl == "fused"
    x = np.random.default_rng(6).uniform(-0.5, 0.5, (3, 48, 48, 3))
    x = x.astype(np.float32)
    jax_model = JaxPartFViT(JaxConfig(**{**arch, "heads": cfg.heads,
                                         "dim_head": cfg.dim_head}))
    want = np.asarray(jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    tracing.enable(traced)
    tracing.reset()
    try:
        with torch.inference_mode():
            got = loaded.model(torch.from_numpy(x)).numpy()
        counters = tracing.export()["counters"]
    finally:
        tracing.enable(False)
        tracing.reset()
    assert counters == ({"attn.fused_fallback": fallbacks}
                        if traced and fallbacks else {})
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) \
        / np.linalg.norm(want, axis=1)
    assert cos.min() >= 1 - 1e-5
