"""PyTorch port: flash attention (``ops/flash_attention.py``) against the
JAX package's ``attn_impl='flash'``.

The JAX path (``models/layers.py::_flash_attention``) pads N to a multiple
of 128, masks the padded keys with ``SegmentIds`` and calls JAX's TPU
flash attention, which has no CPU mode. On the CPU its plain reference
``mha_reference_no_custom_vjp`` (the same ``segment_ids`` and ``sm_scale``,
plain autodiff) stands in for it, with the padding ``layers.py:265-278``
builds and the padded rows sliced off. (``mha_reference`` is not usable:
its products run at bfloat16 matmul precision and its VJP refuses
``sm_scale != 1``.) fp32 throughout; tolerances: the forward 1e-5 and the
VJP 1e-4 relative (max-norm), summation order only.

The SSL step with ``attn_impl='flash'`` (plain versions) is held against
JAX ``make_ssl_train_step`` with ``attn_impl='flash'``, JAX's
``flash_attention`` replaced by the reference with the same arguments,
over 3 steps from one state, as ``tests/test_torch_ssl_step.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jax_flash
from jax.sharding import Mesh

from lafs_cvpr2024_tpu.models import layers as jax_layers
from lafs_cvpr2024_tpu.models.partfvit import PartFViTConfig as JaxConfig
from lafs_cvpr2024_tpu.train import ssl as jax_ssl
from lafs_cvpr2024_tpu_torch.models.layers import Attention
from lafs_cvpr2024_tpu_torch.models.partfvit import PartFViTConfig
from lafs_cvpr2024_tpu_torch.ops.flash_attention import (
    LOG2E,
    flash_attention,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from lafs_cvpr2024_tpu_torch.train.checkpoint import (
    ssl_state_from_flax,
    state_dict_from_flax,
    to_tensors,
)
from lafs_cvpr2024_tpu_torch.train.ssl import (
    SSLConfig,
    assemble_crop_batches,
    make_ssl_train_step,
)

SCALE = 768 ** -0.5  # the model-dim quirk the layer passes as sm_scale
LENGTHS = [37, 128, 130, 197, 300]


def _reference_flash(q, k, v, segment_ids=None, sm_scale=1.0, **_):
    """JAX's flash attention on the CPU: its plain reference, same
    arguments, differentiated by plain autodiff."""
    return jax_flash.mha_reference_no_custom_vjp(
        q, k, v, segment_ids=segment_ids, sm_scale=sm_scale)


@pytest.fixture
def jax_flash_on_cpu(monkeypatch):
    monkeypatch.setattr(jax_flash, "flash_attention", _reference_flash)


def _qkv_do(n: int, seed: int, b: int = 2, h: int = 3):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, 64)).astype(np.float32) * s
                   for s in (2.0, 2.0, 1.0, 1.0))
    return q, k, v, do


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("n", LENGTHS)
def test_flash_plain_forward_matches_jax(jax_flash_on_cpu, n):
    q, k, v, _ = _qkv_do(n, n)
    want = jax_layers._flash_attention(*map(jnp.asarray, (q, k, v)), SCALE)
    got, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), SCALE)
    assert got.shape == want.shape == (2, 3, n, 64)
    assert _rel(got.numpy(), want) <= 1e-5
    # the saved logsumexp is the row's log-partition of the scaled scores
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * SCALE
    m = s.max(-1, keepdims=True)
    lse_want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert _rel(lse.numpy(), lse_want) <= 1e-6


@pytest.mark.parametrize("n", LENGTHS)
def test_flash_vjp_matches_jax(jax_flash_on_cpu, n):
    """The autograd function's dq, dk, dv (``flash_attention_bwd_plain``
    behind it) against the VJP of the padded, segment-masked JAX path."""
    q, k, v, do = _qkv_do(n, 100 + n)
    _, vjp = jax.vjp(lambda a, b_, c: jax_layers._flash_attention(
        a, b_, c, SCALE), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves, SCALE).backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", leaves, want):
        assert _rel(t.grad.numpy(), w) <= 1e-4, name


def test_flash_bwd_plain_is_softmax_attention_vjp():
    """``flash_attention_bwd_plain`` from the forward's O and lse equals
    autograd through plain softmax attention (fp32, 1e-5)."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv_do(57, 3))
    o, lse = flash_attention_plain(q, k, v, SCALE)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, SCALE)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.softmax(leaves[0] @ leaves[1].transpose(-1, -2) * SCALE,
                        -1) @ leaves[2]
    want = torch.autograd.grad(ref, leaves, do)
    for a, w in zip(got, want):
        assert _rel(a.numpy(), w.numpy()) <= 1e-5


@pytest.mark.parametrize("n", LENGTHS)
def test_flash_bwd_twins_match_bwd_plain_and_jax(jax_flash_on_cpu, n):
    """Kernel 11c's plain twin (dQ and the statistics scratch) and kernel
    11b's (dK, dV from that scratch), composed, against
    ``flash_attention_bwd_plain`` and the VJP of the padded,
    segment-masked JAX path (fp32, 1e-4)."""
    q, k, v, do = _qkv_do(n, 200 + n)
    _, vjp = jax.vjp(lambda a, b_, c: jax_layers._flash_attention(
        a, b_, c, SCALE), *map(jnp.asarray, (q, k, v)))
    want_jax = vjp(jnp.asarray(do))
    q, k, v, do = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(q, k, v, SCALE)
    dq, stats = flash_attention_bwd_dq_plain(q, k, v, o, do, lse, SCALE)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, stats, SCALE)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, SCALE)
    for name, a, w, wj in zip("qkv", (dq, dk, dv), want, want_jax):
        assert _rel(a.numpy(), w.numpy()) <= 1e-4, name
        assert _rel(a.numpy(), wj) <= 1e-4, name


@pytest.mark.parametrize("n", LENGTHS)
def test_flash_bwd_statistics_scratch_layout(n):
    """The scratch between 11c and 11b: (B·H, ⌈N/64⌉, 2, 64) fp32, each
    64-row query tile's lse·log2 e, then its rowsum(O ∘ dO); rows past N
    hold +inf and 0, so p = 2^(s·c − lse·log2 e) is exactly 0 there for
    any finite score."""
    b, h = 2, 3
    q, k, v, do = map(torch.from_numpy, _qkv_do(n, 300 + n, b, h))
    o, lse = flash_attention_plain(q, k, v, SCALE)
    _, stats = flash_attention_bwd_dq_plain(q, k, v, o, do, lse, SCALE)
    tiles = -(-n // 64)
    assert stats.shape == (b * h, tiles, 2, 64)
    assert stats.dtype == torch.float32 and stats.is_contiguous()
    rows = stats.permute(0, 2, 1, 3).reshape(b, h, 2, tiles * 64)
    di = (o.double() * do.double()).sum(-1)
    assert _rel(rows[:, :, 0, :n].numpy(), (lse * LOG2E).numpy()) <= 1e-6
    assert _rel(rows[:, :, 1, :n].numpy(), di.numpy()) <= 1e-5
    pad = rows[:, :, :, n:]
    assert bool((pad[:, :, 0] == float("inf")).all())
    assert bool((pad[:, :, 1] == 0).all())
    s = torch.tensor([-1e4, -3.0, 0.0, 5.0, 80.0])
    p = torch.exp2(s[:, None] * (SCALE * LOG2E) - pad[:, :, 0].reshape(-1))
    assert bool((p == 0).all())


def test_attention_layer_flash_matches_einsum():
    """``Attention(attn_impl='flash')`` equals the einsum path on the same
    weights at a local crop's 37 tokens and past 512, with the gradients."""
    torch.manual_seed(0)
    layers = [Attention(128, heads=2, dim_head=64, attn_impl=impl)
              for impl in ("flash", "einsum")]
    layers[0].load_state_dict(layers[1].state_dict())
    for n in (37, 600):
        x = torch.randn(2, n, 128)
        outs = []
        for layer in layers:
            xi = x.clone().requires_grad_()
            y = layer(xi)
            y.square().sum().backward()
            outs.append((y.detach(), xi.grad))
        (ya, ga), (yb, gb) = outs
        assert _rel(ya.numpy(), yb.numpy()) <= 1e-5
        assert _rel(ga.numpy(), gb.numpy()) <= 1e-4


# ------------------------------------------------------------ the step --

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, mlp_dim=256,
            num_patches=36, image_size=48, stn_mode="small", with_land=False,
            loss_type="None", num_classes=0, dropout=0.0, emb_dropout=0.0,
            drop_path_rate=0.0)
RECIPE = dict(out_dim=64, head_hidden_dim=96, head_bottleneck_dim=32,
              local_crops_number=2, landmark_jitter_std=0.0,
              local_keep_landmarks=0)
ARGS = dict(lr=5e-4, wd=0.04, momentum=0.996, teacher_temp=0.04,
            freeze_last=1.0)


def _crops(b=4, seed=0):
    rng = np.random.default_rng(seed)
    crops = [rng.uniform(-1, 1, (b, 48, 48, 3)).astype(np.float32)
             for _ in range(4 + 2 * RECIPE["local_crops_number"])]
    return assemble_crop_batches(crops)


@pytest.fixture(scope="module")
def jax_flash_run():
    """Three JAX steps with attn_impl='flash' (the reference in place of
    the TPU kernel) from one state on one batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_flash, "flash_attention", _reference_flash)
        cfg = jax_ssl.SSLConfig(
            model=JaxConfig(**ARCH, mlp_impl="dense", attn_impl="flash"),
            compute_dtype=jnp.float32, **RECIPE)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        state = jax.jit(lambda r: jax_ssl.create_ssl_state(cfg, r))(
            jax.random.PRNGKey(0))
        land = jax_ssl.create_landmark_provider(cfg, jax.random.PRNGKey(1))
        # running stats away from (0, 1), as tests/test_torch_ssl_step.py
        rng = np.random.default_rng(9)
        land = dict(land, batch_stats=jax.tree_util.tree_map(
            lambda s: np.asarray(s) + rng.uniform(0.1, 0.5, s.shape).astype(
                np.float32), land["batch_stats"]))
        step = jax_ssl.make_ssl_train_step(cfg, mesh)
        batch = tuple(map(jnp.asarray, _crops()))
        args = {k: jnp.float32(v) for k, v in ARGS.items()}
        states, losses = [jax.device_get(state)], []
        for _ in range(3):
            state, m = step(state, land, *batch, **args)
            states.append(jax.device_get(state))
            losses.append(float(m["loss"]))
    return states, jax.tree_util.tree_map(np.asarray, land), losses


def _rel_leaf(got, want):
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def test_ssl_step_with_flash_matches_jax(jax_flash_run):
    states, land, losses = jax_flash_run
    cfg = SSLConfig(model=PartFViTConfig(**ARCH, attn_impl="flash"),
                    compute_dtype=torch.float32, **RECIPE)
    step = make_ssl_train_step(cfg)
    landmark = to_tensors(state_dict_from_flax(land["params"],
                                               land["batch_stats"]))
    batch = tuple(torch.from_numpy(a) for a in _crops())
    state = ssl_state_from_flax(states[0], device="cpu")
    for i in range(3):
        state, m = step(state, landmark, *batch, **ARGS)
        want = ssl_state_from_flax(states[i + 1], device="cpu")
        assert abs(m["loss"].item() - losses[i]) <= 1e-4 * abs(losses[i]), i
        assert _rel_leaf(state.center, want.center) <= 1e-4, i
        for got_t, want_t in ((state.student, want.student),
                              (state.teacher, want.teacher),
                              (state.opt_state.mu, want.opt_state.mu),
                              (state.opt_state.nu, want.opt_state.nu)):
            for k in want_t:
                assert _rel_leaf(got_t[k], want_t[k]) <= 1e-4, (i, k)
