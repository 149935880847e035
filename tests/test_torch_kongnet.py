"""KongNet: the port against the flax model and JAX's detector on the CPU.

Seeded random flax variables of the shapes ``jax.eval_shape`` gives go into
the port through ``flax_kongnet_to_torch``; the port's ``state_dict`` goes
back through JAX's ``torch_kongnet_to_flax`` and must give the same flax
tree, leaf for leaf, which proves the port's names are upstream's. Kernels
are drawn at variance 1/fan_in (40 and more random EfficientNetV2 blocks at
He's 2/fan_in amplify float32 rounding, ``test_torch_efficientnet.py``).
The same seeded float batch then runs through both ``infer_batch``es:
sigmoids within 1e-4, logits within 1e-4 of their largest magnitude.
``preproc`` and the peak ``postproc`` must equal JAX's bit for bit, and the
detector engine over a small synthetic slide must stitch the same canvas
(within 1e-4 of its largest value) and find JAX's detections on it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from tiatoolbox_tpu.models.architecture.kongnet import KongNet as JaxKongNet
from tiatoolbox_tpu.models.architecture.weight_converter import torch_kongnet_to_flax
from tiatoolbox_tpu.models.engine import nucleus_detector as jax_detector
from tiatoolbox_tpu.models.engine.io_config import IOSegmentorConfig as JaxIOConfig
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture import load_weights
from tiatoolbox_tpu_torch.models.architecture.kongnet import KongNet
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_kongnet_to_torch
from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, NucleusDetector
from torch_seeded import assert_same_state, seeded_state

PROB_TOL = 1e-4  # sigmoid outputs, absolute
LOGIT_TOL = 1e-4  # logits, of their largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(module, shape, seed: int) -> dict:
    """Seeded random flax variables of ``module`` at an input of ``shape``:
    kernels at variance 1/fan_in, scales and variances in [0.5, 1.5), biases
    and means N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, size = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0, np.sqrt(1.0 / np.prod(size[:-1])), size).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size).astype(np.float32)
        return rng.normal(0, 0.1, size).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flat_leaves(tree, prefix=()) -> dict:
    """``{path: array}`` of a nested flax tree."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "keys"):
            out.update(flat_leaves(dict(value), (*prefix, key)))
        else:
            out[(*prefix, key)] = np.asarray(value)
    return out


def assert_same_tree(got: dict, want: dict) -> None:
    got, want = flat_leaves(got), flat_leaves(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg="/".join(key))


def make_pair(heads, targets, variant: str = "efficientnetv2_s", *, wide: bool = False, seed: int = 1):
    """The port's and the flax KongNet with the same seeded weights: drawn
    for the port's ``state_dict``, carried to flax by JAX's
    ``torch_kongnet_to_flax`` and back by ``flax_kongnet_to_torch``, which
    must give the same ``state_dict`` (the names both ways)."""
    kwargs = dict(min_distance=3, threshold_abs=0.5, variant=variant, wide_decoder=wide)
    port = KongNet(len(heads), list(heads), list(targets), **kwargs, device="cpu")
    state = seeded_state(port, seed)
    port.load_state_dict(state, strict=True)
    variables = torch_kongnet_to_flax({k: v.numpy() for k, v in state.items()}, variant=variant)
    assert_same_state(flax_kongnet_to_torch(variables), state)
    jax_model = JaxKongNet(len(heads), list(heads), list(targets), **kwargs)
    jax_model.load_weights(variables)
    return jax_model, port, variables


def assert_outputs_match(jax_model, port, x: np.ndarray) -> None:
    want_logits = np.asarray(jax.jit(jax_model.module.apply)(jax_model.variables, x))
    want = np.asarray(jax.nn.sigmoid(want_logits[..., jax_model.target_channels]))
    got = KongNet.infer_batch(port, x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= PROB_TOL
    with torch.inference_mode():
        got_logits = port(torch.from_numpy(x)).numpy()
    assert float(np.abs(got_logits - want_logits).max()) <= LOGIT_TOL * float(np.abs(want_logits).max())


@pytest.mark.parametrize(
    ("heads", "targets", "wide"),
    [((1,), (0,), False), ((3, 2, 3), (2, 4, 5), False), ((3, 3), (1, 5), True)],
    ids=["one-head", "three-heads", "wide-decoder"],
)
def test_v2s_kongnet_matches_flax(heads, targets, wide: bool) -> None:
    jax_model, port, _ = make_pair(heads, targets, wide=wide)
    x = np.random.default_rng(2).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    assert_outputs_match(jax_model, port, x)
    widths = [port.decoders[0].blocks[i].conv2[0].out_channels for i in range(5)]
    assert widths == ([512, 256, 128, 64, 32] if wide else [256, 128, 64, 32, 16])


def test_v2l_kongnet_matches_flax() -> None:
    """The registry's encoder, EfficientNetV2-L, at 64^2 with one head."""
    jax_model, port, _ = make_pair((1,), (0,), variant="efficientnetv2_l", seed=3)
    assert len(port.encoder.model.blocks) == 7 and port.encoder.model.blocks[5][24].conv_pwl.out_channels == 384
    x = np.random.default_rng(4).normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    assert_outputs_match(jax_model, port, x)


def test_v1_encoder_fallback_matches_flax() -> None:
    """The v1 fallback (JAX's converter reads V2 encoders only): flax
    variables from ``jax.eval_shape``, carried by ``flax_kongnet_to_torch``."""
    kwargs = dict(min_distance=3, threshold_abs=0.5, variant="efficientnet_b0")
    jax_model = JaxKongNet(1, [2], [1], **kwargs)
    variables = random_variables(jax_model.module, (1, 64, 64, 3), 5)
    jax_model.load_weights(variables)
    port = KongNet(1, [2], [1], **kwargs, device="cpu")
    port.load_state_dict(flax_kongnet_to_torch(variables), strict=True)
    x = np.random.default_rng(6).normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    assert_outputs_match(jax_model, port, x)


def test_upstream_names() -> None:
    port = KongNet(2, [3, 3], [2, 5], 5, 0.5, variant="efficientnetv2_s", device="cpu")
    state = port.state_dict()
    for key in (
        "encoder.model.conv_stem.weight",
        "encoder.model.blocks.0.1.conv.weight",
        "encoder.model.blocks.1.0.conv_exp.weight",
        "encoder.model.blocks.5.14.se.conv_expand.bias",
        "decoders.1.center.attention.attention.cSE.1.weight",
        "decoders.1.center.attention.attention.cSE.3.bias",
        "decoders.0.center.attention.attention.sSE.0.weight",
        "decoders.0.blocks.0.up.conv1.0.weight",
        "decoders.0.blocks.0.up.conv2.1.running_var",
        "decoders.0.blocks.3.attention1.attention.cSE.1.weight",
        "decoders.0.blocks.4.conv2.1.weight",
        "decoders.1.blocks.4.attention2.attention.sSE.0.bias",
        "heads.1.0.weight",
        "heads.1.0.bias",
    ):
        assert key in state, key
    assert not any(k.startswith("decoders.0.blocks.4.attention1") for k in state)
    with pytest.raises(ValueError, match="must match"):
        KongNet(3, [3, 3], [0], 5, 0.5, variant="efficientnetv2_s", device="cpu")


def test_preproc_equals_jax_bit_for_bit() -> None:
    patch = np.random.default_rng(7).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    got, want = KongNet.preproc(patch), JaxKongNet.preproc(patch)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _peak_maps() -> list[np.ndarray]:
    rng = np.random.default_rng(8)
    smooth = np.stack([ndimage.gaussian_filter(rng.random((96, 80)), 2.5) for _ in range(3)], -1)
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    ties = np.zeros((40, 40, 2), np.float32)
    ties[5::9, 7::11, 0] = 0.9
    ties[10:13, 10:13, 1] = 0.8  # a plateau
    return [smooth.astype(np.float32), ties]


@pytest.mark.parametrize(("min_distance", "threshold"), [(3, 0.5), (5, 0.7), (1, 0.0)])
def test_postproc_equals_jax_bit_for_bit(min_distance: int, threshold: float) -> None:
    jax_model = JaxKongNet(1, [1], [0], min_distance, threshold, variant="efficientnetv2_s")
    port = KongNet(1, [1], [0], min_distance, threshold, variant="efficientnetv2_s", device="cpu")
    for block in _peak_maps():
        got, want = port.postproc(block), jax_model.postproc(block)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port.postproc(block, min_distance=2, threshold_abs=0.3),
                                      jax_model.postproc(block, min_distance=2, threshold_abs=0.3))
    assert port.postproc(_peak_maps()[0]).sum() > 0


@pytest.fixture(scope="module")
def two_heads():
    """A 2-head V2-S pair (targets 2 and 5), shared by the tests below."""
    return make_pair((3, 3), (2, 5), seed=10)


def test_load_weights_npz_and_wrapped_pth(two_heads, tmp_path) -> None:
    """A flax ``.npz`` through the converter; a ``.pth`` in KongNet's ``"model"``
    wrapper, with the unused SCSE of the last block an upstream checkpoint may hold."""
    _, port, variables = two_heads
    flat = {"/".join(k): v for k, v in flat_leaves(variables).items()}
    np.savez(tmp_path / "k.npz", **flat)
    fresh = KongNet(2, [3, 3], [2, 5], 3, 0.5, variant="efficientnetv2_s", seed=4, device="cpu")
    load_weights(fresh, tmp_path / "k.npz")
    assert_same_state(fresh.state_dict(), port.state_dict())
    state = dict(port.state_dict())
    state["decoders.0.blocks.4.attention1.attention.cSE.1.weight"] = torch.zeros(1, 16, 1, 1)
    torch.save({"model": state, "epoch": 3}, tmp_path / "k.pth")
    fresh = KongNet(2, [3, 3], [2, 5], 3, 0.5, variant="efficientnetv2_s", seed=5, device="cpu")
    load_weights(fresh, tmp_path / "k.pth")
    assert_same_state(fresh.state_dict(), port.state_dict())


class _Recording:
    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:
        self.canvas = np.array(raw_predictions["probabilities"])
        return super().post_process_wsi(raw_predictions, **kwargs)


class _PortDetector(_Recording, NucleusDetector):
    pass


class _JaxDetector(_Recording, jax_detector.NucleusDetector):
    pass


def test_detector_engine_matches_jax(two_heads, tmp_path) -> None:
    """``NucleusDetector`` over a 2-head V2-S KongNet on a 176x120 slide at
    0.5 mpp (64^2 patches at stride 56, the per-patch feed: KongNet's own
    preproc), against JAX's engine: the canvas and its detections; then patch mode."""
    jax_model, port, _ = two_heads
    slide = str(make_synthetic_slide(tmp_path / "k.tiff", size=(176, 120), mpp=0.5, seed=11, compression="deflate"))
    kwargs = dict(PRETRAINED_MODELS["KongNet_CoNIC_1"]["ioconfig"]["kwargs"])
    kwargs.update(patch_input_shape=[64, 64], patch_output_shape=[64, 64], stride_shape=[56, 56])
    common = dict(patch_mode=False, auto_get_mask=False)
    jax_engine = _JaxDetector(jax_model, batch_size=4, num_loader_workers=0, verbose=False)
    jax_engine.run([slide], ioconfig=JaxIOConfig(**kwargs), **common)
    threshold = float(np.quantile(jax_engine.canvas, 0.99))
    engine = _PortDetector(port, batch_size=4, num_loader_workers=0, verbose=False, device="cpu")
    got = engine.run([slide], ioconfig=IOSegmentorConfig(**kwargs), threshold_abs=threshold, min_distance=3, **common)[slide]
    assert engine.last_stage_summary["path"] == "device-canvas"
    assert engine.canvas.shape == jax_engine.canvas.shape == (120, 176, 2)
    assert float(np.abs(engine.canvas - jax_engine.canvas).max()) <= PROB_TOL
    judge = jax_detector.NucleusDetector(jax_model, verbose=False)
    judge.threshold_abs, judge.min_distance = threshold, 3
    want = judge.post_process_wsi({"probabilities": engine.canvas})
    for key in ("coordinates", "scores", "types"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["coordinates"]) > 3 and set(np.unique(got["types"])) == {0, 1}
    patches = np.stack([synthetic_he_patch((64, 64), seed=s) for s in (1, 2)])
    out_p = NucleusDetector(port, batch_size=4, verbose=False, device="cpu").run(patches, patch_mode=True)
    out_j = jax_detector.NucleusDetector(jax_model, batch_size=4, verbose=False).run(patches, patch_mode=True)
    assert float(np.abs(out_p["probabilities"] - np.asarray(out_j["probabilities"])).max()) <= PROB_TOL
