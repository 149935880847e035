"""Vision Transformer encoders and the timm wrappers: the port against the flax modules on the CPU.

Random flax variables of the shapes ``jax.eval_shape`` gives (dense kernels
with variance 1/fan_in, layer-scale gammas of 0.5 so that the blocks count,
norm scales in [0.5, 1.5], the rest N(0, 0.1)) go through
``flax_vit_to_torch`` into the port. A narrow ViT (patch 8, width 64, depth
2, 4 heads, 64^2 input) runs in four variants: plain, layer scale with
register tokens, SwiGLU, and mean pooling; ``TimmBackbone`` and
``TimmModel`` run H0-mini (registers and SwiGLU) at full width on one 224^2
patch. Tolerance: embeddings within 1e-4 of their largest |value|,
probabilities 1e-4 absolute (float32). The port's ``state_dict`` goes
through JAX's ``torch_vit_to_flax`` and back bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture import vit as jax_vit
from tiatoolbox_tpu.models.architecture.weight_converter import torch_vit_to_flax
from tiatoolbox_tpu_torch.models.architecture import vit
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_timm_to_torch, flax_vit_to_torch

TOL = 1e-4
NARROW = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4)
VARIANTS = {
    "plain": {},
    "layer_scale_registers": dict(init_values=1e-5, reg_tokens=3),
    "swiglu": dict(swiglu=True, init_values=1e-5, reg_tokens=2),
    "mean_pool": dict(pool="mean"),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(module, size: int, seed: int) -> dict:
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = np.prod(shape[:-2]) if path[-2].key in ("query", "key", "value") else np.prod(shape[:-1])
            if path[-2].key == "out":
                fan_in = shape[0] * shape[1]
            return rng.normal(0, np.sqrt(1.0 / fan_in), shape).astype(np.float32)
        if name in ("ls1", "ls2"):
            return np.full(shape, 0.5, np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_narrow_vit_matches_flax(variant: str) -> None:
    cfg = {**NARROW, **VARIANTS[variant]}
    flax = jax_vit.VisionTransformer(**cfg)
    variables = random_variables(flax, 64, seed=len(variant))
    port = vit.VisionTransformer(**cfg, img_size=64).eval()
    port.load_state_dict(flax_vit_to_torch(variables), strict=True)
    x = np.random.default_rng(1).random((3, 64, 64, 3), dtype=np.float32)
    want = np.asarray(jax.jit(flax.apply)(variables, x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 64)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_round_trips_through_the_jax_converter(variant: str) -> None:
    """port -> ``torch_vit_to_flax`` -> ``flax_vit_to_torch`` is the identity, bit for bit."""
    port = vit.VisionTransformer(**NARROW, **VARIANTS[variant], img_size=64)
    state = port.state_dict()
    flax_vars = torch_vit_to_flax({k: v.numpy() for k, v in state.items()}, num_heads=NARROW["num_heads"])
    back = flax_vit_to_torch(flax_vars)
    assert set(back) == set(state)
    for key, value in state.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    # and the flax tree is the one the flax module builds
    flax = jax_vit.VisionTransformer(**NARROW, **VARIANTS[variant])
    shapes = jax.eval_shape(lambda: flax.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, flax_vars)
    )
    for want, got in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(flax_vars)):
        assert want.shape == np.shape(got)


_H0: dict = {}


def h0_mini_variables(classes: int | None) -> dict:
    """Random flax variables of H0-mini at full width (without or with a head)."""
    if classes not in _H0:
        jax_model = (
            jax_vit.TimmBackbone("H0-mini") if classes is None else jax_vit.TimmModel("H0-mini", num_classes=classes)
        )
        _H0[classes] = (jax_model, random_variables(jax_model.module, 224, seed=5))
    return _H0[classes]


def test_timm_backbone_h0_mini_matches_flax() -> None:
    jax_model, variables = h0_mini_variables(None)
    jax_model.load_weights(variables)
    port = vit.TimmBackbone("H0-mini", device="cpu")
    port.load_state_dict(flax_timm_to_torch(variables, classifier=False), strict=True)
    batch = np.random.default_rng(6).integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)
    got = vit.TimmBackbone.infer_batch(port, batch)
    want = np.asarray(jax_vit.TimmBackbone.infer_batch(jax_model, batch))
    assert got.shape == want.shape == (1, 768)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_timm_model_h0_mini_softmax_matches_flax() -> None:
    jax_model, variables = h0_mini_variables(4)
    jax_model.load_weights(variables)
    port = vit.TimmModel("H0-mini", num_classes=4, device="cpu")
    port.load_state_dict(flax_timm_to_torch(variables, classifier=True), strict=True)
    batch = np.random.default_rng(7).integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)
    got = vit.TimmModel.infer_batch(port, batch)
    want = np.asarray(jax_vit.TimmModel.infer_batch(jax_model, batch))
    assert got.shape == (1, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_infer_batch_divides_any_dtype_by_255() -> None:
    """As JAX's wrappers do, a float batch is divided by 255 too (no model-ready
    float path, unlike ``ModelABC.apply_u8``), and no mean/std is applied."""
    port = vit.TimmBackbone("efficientnet_b0", device="cpu", seed=3)
    batch = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    as_u8 = vit.TimmBackbone.infer_batch(port, batch)
    as_float = vit.TimmBackbone.infer_batch(port, batch.astype(np.float32))
    np.testing.assert_array_equal(as_u8, as_float)
    with torch.inference_mode():
        want = port(torch.from_numpy(batch).float() / 255.0).numpy()
    np.testing.assert_array_equal(as_u8, want)


def test_configs_pos_embed_and_unknown_backbones() -> None:
    assert vit.VIT_CONFIGS == jax_vit.VIT_CONFIGS
    model = vit.VisionTransformer(**vit.VIT_CONFIGS["H0-mini"])
    assert model.pos_embed.shape == (1, 16 * 16 + 1, 768) and model.reg_token.shape == (1, 4, 768)
    assert model.blocks[0].mlp.fc1.out_features == 2 * 3072 and model.blocks[0].ls1.gamma.shape == (768,)
    assert {m.eps for m in model.modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-6}
    for cls in (vit.TimmBackbone, vit.TimmModel):
        with pytest.raises(ValueError, match="not supported"):
            cls("vit_giant", device="cpu")
        with pytest.raises(ValueError, match="not supported"):
            cls("efficientnet_b9", device="cpu")
