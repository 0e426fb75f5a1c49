"""PyTorch port: checkpoint interop and eval loading.

``state_dict_from_flax`` must equal the JAX package's
``export_torch_state_dict`` key for key and bit for bit; a ``.pth`` written
by the JAX package's ``save_torch_state_dict`` must round-trip through the
port's ``load_eval_model`` (``strict=True``), and the port's
``infer_partfvit_config`` must infer what the JAX one infers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.eval.loading import (
    infer_partfvit_config as jax_infer,
)
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train.checkpoint import (
    export_torch_state_dict,
    save_torch_state_dict,
)
from lafs_cvpr2024_tpu_torch.eval.loading import (
    infer_partfvit_config,
    load_eval_model,
)
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    state_dict_from_flax,
    strip_prefixes,
)

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=16, image_size=32, loss_type="None", num_classes=0)
# the port serves through its kernels by default; every other field of the
# inferred config must match the JAX package's
_IMPL_FIELDS = {"gather_impl", "mlp_impl", "attn_impl"}


@pytest.fixture(scope="module", params=["small", "large"])
def jax_tree(request):
    cfg = JaxConfig(**ARCH, stn_mode=request.param)
    model = JaxPartFViT(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    return model, jax.tree_util.tree_map(np.asarray, v)


def test_state_dict_from_flax_equals_export(jax_tree):
    _, v = jax_tree
    got = state_dict_from_flax(v["params"], v["batch_stats"])
    want = export_torch_state_dict(v["params"], v["batch_stats"])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_pth_round_trips_through_load_eval_model(jax_tree, tmp_path):
    model, v = jax_tree
    sd = export_torch_state_dict(v["params"], v["batch_stats"])
    # the reference's prefixes and margin head must not stop a strict load
    sd = {f"module.{k}": a for k, a in sd.items()}
    sd["module.loss.weight"] = np.zeros((5, 128), np.float32)
    path = str(tmp_path / "model.pth")
    save_torch_state_dict(sd, path)
    logs = []
    loaded = load_eval_model(path, {"image_size": 32}, device="cpu",
                             log=logs.append)
    assert loaded.family == "partfvit" and not loaded.model.training
    assert any("architecture" in m for m in logs)
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 32, 32, 3))
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    with torch.no_grad():
        got = loaded.model(torch.from_numpy(x)).numpy()
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) \
        / np.linalg.norm(want, axis=1)
    assert cos.min() >= 1 - 1e-5


def test_infer_matches_jax(jax_tree):
    _, v = jax_tree
    sd = strip_prefixes(export_torch_state_dict(v["params"], v["batch_stats"]))
    for ov in ({}, {"heads": 4}, {"depth": 1, "image_size": 64,
                                  "pool": "mean"}):
        got = dataclasses.asdict(infer_partfvit_config(sd, **ov))
        want = dataclasses.asdict(jax_infer(v["params"], **ov))
        assert got["attn_impl"] == "fused", ov  # the eval models' choice
        for name in _IMPL_FIELDS:
            got.pop(name), want.pop(name)
        assert got == want, ov


def test_infer_rejects_unknown_overrides_and_foreign_trees(jax_tree):
    _, v = jax_tree
    sd = export_torch_state_dict(v["params"], v["batch_stats"])
    with pytest.raises(TypeError, match="unknown config overrides"):
        infer_partfvit_config(sd, bogus=1)
    with pytest.raises(ValueError, match="cls_token"):
        infer_partfvit_config({"blocks.0.attn.qkv.weight": np.zeros((3, 3))})


def test_state_dict_from_flax_refuses_unmapped_paths(jax_tree):
    _, v = jax_tree
    params = dict(v["params"], global_token={"kernel": np.zeros((160, 128))})
    with pytest.raises(ValueError, match="global_token"):
        state_dict_from_flax(params, v["batch_stats"])


def test_load_eval_model_refuses_other_payloads(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_eval_model(str(tmp_path), device="cpu")
    path = str(tmp_path / "vit.pth")
    torch.save({"blocks.0.attn.qkv.weight": torch.zeros(3, 3),
                "cls_token": torch.zeros(1, 1, 3)}, path)
    with pytest.raises(ValueError, match="dino_vit"):
        load_eval_model(path, device="cpu")
