"""PyTorch port: the embedding server.

The port's server runs on the CPU (``--device cpu --eval-dtype float32``)
in a thread and is driven by the JAX package's ``EmbeddingClient``, so the
wire format is checked from the other side. Its embeddings must match the
JAX ``EmbeddingServer`` on the same ``.pth`` (batch 8, a multiple of the
8 virtual CPU devices) to cosine ≥ 1 − 1e-5.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lafs_cvpr2024_tpu.cli import serve_embeddings as jax_serve
from lafs_cvpr2024_tpu.models.partfvit import PartFViT as JaxPartFViT
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train.checkpoint import (
    export_torch_state_dict,
    save_torch_state_dict,
)
from lafs_cvpr2024_tpu_torch.cli import serve_embeddings

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="small",
            loss_type="None", num_classes=0)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    model = JaxPartFViT(JaxConfig(**ARCH))
    v = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 48, 48, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    path = str(tmp_path_factory.mktemp("serve") / "model.pth")
    save_torch_state_dict(
        export_torch_state_dict(v["params"], v["batch_stats"]), path)
    return path


def _argv(pth, sock, *extra):
    return ["--checkpoint", pth, "--socket", sock, "--batch-size", "8",
            "--image-size", "48", "--eval-dtype", "float32", *extra]


def test_port_server_matches_jax_server(pth, tmp_path, monkeypatch):
    # a relative socket path: unix socket paths are limited to 107 bytes,
    # and the temporary directory may be deep
    monkeypatch.chdir(tmp_path)
    sock = "port.sock"
    t = threading.Thread(
        target=serve_embeddings.main,
        args=(_argv(pth, sock, "--device", "cpu", "--max-requests", "4"),),
        daemon=True)
    t.start()
    deadline = time.time() + 120
    while not os.path.exists(sock):
        assert t.is_alive() and time.time() < deadline, "server did not start"
        time.sleep(0.1)

    client = jax_serve.EmbeddingClient(sock)  # the JAX package's client
    imgs = np.random.default_rng(0).integers(0, 256, (11, 48, 48, 3),
                                             dtype=np.uint8)
    got = client.embed(imgs)  # 11 > batch 8: chunked and padded
    assert got.shape == (11, 128) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    streamed = list(client.embed_stream([imgs[:3], imgs[3:]]))
    np.testing.assert_allclose(np.concatenate(streamed), got, atol=1e-6)

    want = jax_serve.EmbeddingServer(
        jax_serve.get_args(_argv(pth, "jax.sock"))
    ).embed(imgs)
    assert (got * want).sum(1).min() >= 1 - 1e-5  # both unit-norm

    with pytest.raises(RuntimeError, match="JPEG ingestion .* not yet ported"):
        client.embed_jpegs([b"\xff\xd8\xff", b"\xff\xd8"],
                           np.zeros((2, 5, 2), np.float32))
    with pytest.raises(RuntimeError, match="expected 48x48"):
        client.embed(imgs[:, :32, :32])
    t.join(timeout=60)
    assert not t.is_alive()


def test_server_requires_cuda_unless_cpu_is_explicit(pth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    args = serve_embeddings.get_args(_argv(pth, str(tmp_path / "s.sock")))
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_embeddings.EmbeddingServer(args)
