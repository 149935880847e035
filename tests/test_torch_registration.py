"""The port's whole-slide registration against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages:

- ``utils.metrics`` and ``utils.metaimage``: equal results, ``write_mha``'s
  bytes equal, each package reading the other's files;
- ``utils.warp`` against ``cv2`` itself: ``warp_affine``, ``remap_linear``,
  ``resize_linear`` and ``box_blur`` bit for bit on uint8 over rotations,
  scales, border values and ragged sizes, and on float32/float64 (resize:
  within one float32 rounding, 1e-13 in float64); ``imresize(...,
  "linear")`` on uint8 equals ``cv2.resize``;
- ``prealignment`` (transform, Dice, warped image and mask),
  ``match_histograms``, ``apply_bspline_transform`` and
  ``TransformedWSIReader`` reads equal JAX's;
- VGG16's features through ``flax_vgg_to_torch`` within 1e-4 of the
  largest feature, and DFBR's matches and transform equal JAX's from the
  same features;
- the B-spline step: the dense field within 2e-6 (of its largest value)
  of ``jax.image.resize``, Adam within 1e-6 of ``optax.adam`` over three
  steps, and a whole ``estimate_bspline_transform`` at 96^2 with 80 steps
  (JAX's own test case) within 1e-3 px of JAX's field.
"""

from __future__ import annotations

import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.models.architecture.vgg import VGG16Features as FlaxVGG16Features
from tiatoolbox_tpu.tools.registration import wsi_registration as jreg
from tiatoolbox_tpu.utils import metaimage as jmeta
from tiatoolbox_tpu.utils import metrics as jmetrics
from tiatoolbox_tpu.wsicore import store_reader as jstore
from tiatoolbox_tpu.wsicore.wsimeta import WSIMeta as JaxWSIMeta
from tiatoolbox_tpu_torch.models.architecture.vgg import VGG16Features, seeded_vgg16_state
from tiatoolbox_tpu_torch.models.architecture.weight_converter import (
    flax_vgg_to_torch,
    torchvision_vgg16_features,
)
from tiatoolbox_tpu_torch.tools.registration import wsi_registration as preg
from tiatoolbox_tpu_torch.utils import metaimage as pmeta
from tiatoolbox_tpu_torch.utils import metrics as pmetrics
from tiatoolbox_tpu_torch.utils import warp
from tiatoolbox_tpu_torch.utils.transforms import imresize
from tiatoolbox_tpu_torch.wsicore import store_reader as pstore
from tiatoolbox_tpu_torch.wsicore.tiffio import TiffPyramidWriter
from tiatoolbox_tpu_torch.wsicore.wsimeta import WSIMeta

FEATURE_TOL = 1e-4  # VGG16 features, of the largest |feature|
FIELD_WEIGHT_TOL = 2e-6  # dense field against jax.image.resize, of its largest |value|
ADAM_TOL = 1e-6
BSPLINE_TOL_PX = 1e-3  # a whole 80-step estimate against JAX's
RESIZE_TOL = {np.uint8: 0, np.float32: 2.4e-7, np.float64: 1e-13}  # on [0, 1] floats
RESIZE_TOL_ONE_PIXEL_SIDE = 1e-5  # floats from a source one pixel wide or high


def rng_image(rng: np.random.Generator, shape, dtype) -> np.ndarray:
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape).astype(dtype)


def random_case(seed: int, dtype, max_side: int = 160):
    """A seeded image, affine, output size and border value."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, max_side, 2))
    shape = (h, w) if seed % 2 else (h, w, 3)
    image = rng_image(rng, shape, dtype)
    matrix = cv2.getRotationMatrix2D(
        (float(rng.uniform(0, w)), float(rng.uniform(0, h))), float(rng.uniform(-180, 180)), float(rng.uniform(0.3, 3))
    )
    matrix[:, 2] += rng.uniform(-30, 30, 2)
    dsize = tuple(int(v) for v in rng.integers(1, max_side, 2))
    border = float(rng.integers(0, 256)) if dtype == np.uint8 else float(rng.random())
    return image, matrix, dsize, border


class Messages(logging.Handler):
    """The port logger's messages (it does not propagate to pytest's caplog)."""

    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


@pytest.fixture
def port_warnings():
    handler = Messages()
    logger = logging.getLogger("tiatoolbox_tpu_torch")
    logger.addHandler(handler)
    yield handler.messages
    logger.removeHandler(handler)


def cv2_border(border: float, image: np.ndarray):
    return (border,) * 3 if image.ndim == 3 else border


# -- metrics and MetaImage ------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_jax(seed) -> None:
    rng = np.random.default_rng(seed)
    a = rng.random((30, 2)) * 100
    b = np.concatenate([a[:20] + rng.normal(0, 2, (20, 2)), rng.random((7, 2)) * 100])
    for got, want in zip(pmetrics.pair_coordinates(a, b, 6.0), jmetrics.pair_coordinates(a, b, 6.0)):
        assert np.array_equal(got, want)
    assert pmetrics.f1_detection(a, b, 6.0) == jmetrics.f1_detection(a, b, 6.0)
    m1, m2 = rng.random((40, 50)) > 0.5, rng.random((40, 50)) > 0.3
    assert pmetrics.dice(m1, m2) == jmetrics.dice(m1, m2)
    assert np.isnan(pmetrics.dice(np.zeros((3, 3)), np.zeros((3, 3))))
    with pytest.raises(ValueError, match="Shape mismatch"):
        pmetrics.dice(m1, m2[:-1])


MHA_ARRAYS = {
    "field": (lambda r: r.normal(0, 3, (20, 30, 2)).astype(np.float32), {}),
    "scalar": (lambda r: r.random((17, 9)).astype(np.float64), {"spacing": (0.5, 0.25)}),
    "rgb_compressed": (lambda r: r.integers(0, 256, (12, 14, 3)).astype(np.uint8), {"compressed": True}),
    "volume": (lambda r: r.integers(-5, 5, (4, 6, 3)).astype(np.int16), {"vector": False}),
}


@pytest.mark.parametrize("name", sorted(MHA_ARRAYS))
def test_write_mha_bytes_and_round_trips(tmp_path, name) -> None:
    make, kwargs = MHA_ARRAYS[name]
    array = make(np.random.default_rng(len(name)))
    ours = pmeta.write_mha(tmp_path / "port.mha", array, **kwargs)
    theirs = jmeta.write_mha(tmp_path / "jax.mha", array, **kwargs)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader in (pmeta.read_mha, jmeta.read_mha):
        for path in (ours, theirs):
            got = reader(path)
            assert got.dtype == array.dtype and np.array_equal(got, array)


def test_load_transform_equal_jax(tmp_path) -> None:
    rng = np.random.default_rng(3)
    affine = rng.normal(size=(3, 3))
    np.save(tmp_path / "affine.npy", affine)
    np.save(tmp_path / "short.npy", affine[:2])
    np.save(tmp_path / "bad.npy", rng.random((4, 4)))
    field = rng.normal(size=(9, 11, 2)).astype(np.float32)
    pmeta.write_mha(tmp_path / "field.mha", field)
    for name in ("affine.npy", "short.npy", "field.mha"):
        got = pmeta.load_transform(tmp_path / name)
        assert np.array_equal(got, jmeta.load_transform(tmp_path / name))
    assert np.array_equal(pmeta.load_transform(tmp_path / "short.npy")[2], [0, 0, 1])
    with pytest.raises(ValueError, match="expected a 3x3"):
        pmeta.load_transform(tmp_path / "bad.npy")
    (tmp_path / "t.txt").write_text("1")
    with pytest.raises(ValueError, match="Unsupported transform"):
        pmeta.load_transform(tmp_path / "t.txt")


# -- OpenCV's geometry ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(16))
def test_warp_affine_uint8_bit_exact(seed) -> None:
    image, matrix, dsize, border = random_case(seed, np.uint8)
    want = cv2.warpAffine(image, matrix, dsize, borderValue=cv2_border(border, image))
    assert np.array_equal(warp.warp_affine(image, matrix, dsize, border), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_float_exact(seed, dtype) -> None:
    image, matrix, dsize, border = random_case(100 + seed, dtype)
    want = cv2.warpAffine(image, matrix, dsize, borderValue=cv2_border(border, image))
    got = warp.warp_affine(image, matrix, dsize, border)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("angle", [0.0, 10.0, 33.0, 90.0, -135.0, 180.0])
def test_warp_affine_rotations_of_a_mask(angle) -> None:
    """prealignment's warp: a 0/1 mask rotated about a centre, border 0."""
    mask = (np.random.default_rng(7).random((150, 203)) > 0.6).astype(np.uint8)
    matrix = cv2.getRotationMatrix2D((97.3, 71.9), angle, 1.0)
    assert np.array_equal(warp.warp_affine(mask, matrix, (203, 150)), cv2.warpAffine(mask, matrix, (203, 150)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_remap_linear_exact(seed, dtype) -> None:
    rng = np.random.default_rng(200 + seed)
    h, w = (int(v) for v in rng.integers(1, 120, 2))
    image = rng_image(rng, (h, w, 3) if seed % 2 else (h, w), dtype)
    out_h, out_w = (int(v) for v in rng.integers(1, 120, 2))
    map_x = (rng.random((out_h, out_w)) * (w + 8) - 4).astype(np.float32)
    map_y = (rng.random((out_h, out_w)) * (h + 8) - 4).astype(np.float32)
    border = 255 if dtype == np.uint8 else 0.5
    want = cv2.remap(image, map_x, map_y, interpolation=cv2.INTER_LINEAR, borderValue=cv2_border(border, image))
    assert np.array_equal(warp.remap_linear(image, map_x, map_y, border), want)


RESIZES = [((10, 10), (20, 20)), ((7, 13), (26, 21)), ((5, 7), (143, 97)), ((256, 256), (224, 224)),
           ((100, 60), (50, 30)), ((101, 61), (50, 30)), ((97, 143), (5, 7)), ((1, 9), (4, 3)), ((33, 1), (5, 40))]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
@pytest.mark.parametrize(("src_hw", "dst_wh"), RESIZES)
def test_resize_linear_against_cv2(src_hw, dst_wh, dtype) -> None:
    rng = np.random.default_rng(src_hw[0] * 1000 + dst_wh[0])
    for shape in (src_hw, (*src_hw, 3)):
        image = rng_image(rng, shape, dtype)
        want = cv2.resize(image, dst_wh, interpolation=cv2.INTER_LINEAR)
        got = warp.resize_linear(image, dst_wh)
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = RESIZE_TOL[dtype] if dtype == np.uint8 or min(src_hw) > 1 else RESIZE_TOL_ONE_PIXEL_SIDE
        assert np.abs(got.astype(np.float64) - want).max() <= tol


@pytest.mark.parametrize(("src_hw", "dst_wh"), RESIZES)
def test_imresize_linear_uint8_is_cv2(src_hw, dst_wh) -> None:
    image = np.random.default_rng(5).integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    want = cv2.resize(image, dst_wh, interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(imresize(image, output_size=dst_wh, interpolation="linear"), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(("src_hw", "dst_wh"), RESIZES)
def test_imresize_linear_float_is_resize_linear(src_hw, dst_wh, dtype) -> None:
    """Float images take the same linear resize as uint8 ones, within
    ``RESIZE_TOL`` of cv2."""
    image = rng_image(np.random.default_rng(src_hw[1] * 1000 + dst_wh[1]), (*src_hw, 3), dtype)
    got = imresize(image, output_size=dst_wh, interpolation="linear")
    assert got.dtype == dtype and np.array_equal(got, warp.resize_linear(image, dst_wh))
    want = cv2.resize(image, dst_wh, interpolation=cv2.INTER_LINEAR)
    tol = RESIZE_TOL[dtype] if min(src_hw) > 1 else RESIZE_TOL_ONE_PIXEL_SIDE
    assert np.abs(got.astype(np.float64) - want).max() <= tol


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
@pytest.mark.parametrize("ksize", [(7, 7), (3, 3), (5, 5), (2, 6), (4, 3), (6, 2), (11, 11), (17, 17)])
def test_box_blur_exact(ksize, dtype) -> None:
    rng = np.random.default_rng(ksize[0] * 31 + ksize[1])
    for shape in ((1, 40), (23, 2), (61, 47), (37, 53, 3)):
        image = rng_image(rng, shape, dtype)
        assert np.array_equal(warp.box_blur(image, ksize), cv2.blur(image, ksize))


def test_warp_refuses_what_cv2_would_not_take() -> None:
    with pytest.raises(ValueError, match="uint8, float32 or float64"):
        warp.warp_affine(np.zeros((4, 4), np.int32), np.eye(3)[:2], (4, 4))
    with pytest.raises(ValueError, match="non-empty"):
        warp.resize_linear(np.zeros((0, 4), np.uint8), (2, 2))
    with pytest.raises(ValueError, match="positive output size"):
        warp.resize_linear(np.zeros((4, 4), np.uint8), (0, 2))
    with pytest.raises(ValueError, match="two \\[h, w\\] maps"):
        warp.remap_linear(np.zeros((4, 4), np.uint8), np.zeros((2, 2)), np.zeros((2, 3)))


# -- prealignment and histograms ------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """JAX's registration test pair: a 256^2 H&E patch and its 40 degree rotation."""
    fixed = synthetic_he_patch((256, 256), seed=7)
    rotation = cv2.getRotationMatrix2D((128, 128), 40, 1.0)
    moving = cv2.warpAffine(fixed, rotation, (256, 256), borderValue=(255, 255, 255))
    grey_f = cv2.cvtColor(fixed, cv2.COLOR_RGB2GRAY)
    grey_m = cv2.cvtColor(moving, cv2.COLOR_RGB2GRAY)
    return fixed, moving, (grey_f < 220).astype(np.uint8), (grey_m < 220).astype(np.uint8)


@pytest.mark.parametrize(("rotation_step", "dice_overlap"), [(10, 0.5), (15, 0.5), (20, 0.3), (10, 0.99)])
def test_prealignment_equals_jax(pair, rotation_step, dice_overlap, port_warnings) -> None:
    fixed, moving, fixed_mask, moving_mask = pair
    args = (fixed, moving, fixed_mask, moving_mask, dice_overlap, rotation_step)
    got = preg.prealignment(*args)
    want = jreg.prealignment(*args)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3] == want[3]
    if dice_overlap == 0.99:
        assert np.array_equal(got[0], np.eye(3))
        assert any("Not able to find the best transformation" in m for m in port_warnings)
    else:
        assert not np.allclose(got[0], np.eye(3))


def test_prealignment_validation(pair) -> None:
    fixed, moving, fixed_mask, moving_mask = pair
    with pytest.raises(ValueError, match="rotation step"):
        preg.prealignment(fixed, moving, fixed_mask, moving_mask, rotation_step=5)
    with pytest.raises(ValueError, match="dice_overlap"):
        preg.prealignment(fixed, moving, fixed_mask, moving_mask, dice_overlap=2)
    with pytest.raises(ValueError, match="foreground is missing"):
        preg.prealignment(fixed, moving, fixed_mask * 0, moving_mask)
    with pytest.raises(ValueError, match="Mismatch of shape"):
        preg.prealignment(fixed, moving, fixed_mask[:-1], moving_mask)


@pytest.mark.parametrize("kind", ["uint8", "float64", "kernel5"])
def test_match_histograms_equals_jax(pair, kind) -> None:
    fixed, moving, *_ = pair
    a, b = cv2.cvtColor(fixed, cv2.COLOR_RGB2GRAY), cv2.cvtColor(moving, cv2.COLOR_RGB2GRAY)
    kernel = 5 if kind == "kernel5" else 7
    if kind == "float64":
        a, b = a / 255.0, b / 255.0
    for got, want in zip(preg.match_histograms(a, b, kernel), jreg.match_histograms(a, b, kernel)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_helpers_equal_jax(pair) -> None:
    fixed, moving, fixed_mask, _ = pair
    assert preg.compute_center_of_mass(fixed_mask) == jreg.compute_center_of_mass(fixed_mask)
    assert preg.compute_center_of_mass(fixed_mask * 0) == jreg.compute_center_of_mass(fixed_mask * 0)
    transform = np.array([[0.9, -0.2, 14.5], [0.25, 1.1, -7.25], [0, 0, 1]])
    for img in (moving, fixed_mask, fixed.astype(np.float32) / 255):
        want = jreg.apply_affine_transformation(fixed, img, transform)
        assert np.array_equal(preg.apply_affine_transformation(fixed, img, transform), want)
    for img in (fixed, fixed_mask, fixed_mask * 255, fixed[..., :1]):
        assert np.array_equal(preg._to_grey_float(img), jreg._to_grey_float(img))


# -- VGG16 and DFBR --------------------------------------------------------------


def flax_vgg_variables(seed: int) -> dict:
    """Seeded flax variables of JAX's VGG16Features, shaped by ``jax.eval_shape``."""
    shapes = jax.eval_shape(lambda: FlaxVGG16Features().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            return rng.normal(0, np.sqrt(2.0 / np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def vgg_variables():
    return flax_vgg_variables(3)


@pytest.mark.parametrize("side", [32, 64])
def test_vgg16_features_through_converter(vgg_variables, side) -> None:
    model = VGG16Features().eval()
    model.load_state_dict(flax_vgg_to_torch(vgg_variables))
    x = np.random.default_rng(side).random((2, side, side, 3), dtype=np.float32)
    want = FlaxVGG16Features().apply(vgg_variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= FEATURE_TOL * np.abs(w).max()


def test_vgg16_state_names_and_seeded_init() -> None:
    model = VGG16Features()
    state = seeded_vgg16_state(0)
    assert list(state) == list(model.state_dict())
    model.load_state_dict(state)
    assert all(torch.equal(state[k], v) for k, v in seeded_vgg16_state(0).items())
    assert not torch.equal(state["features.0.weight"], seeded_vgg16_state(1)["features.0.weight"])


def test_torchvision_checkpoint_loads_by_name(tmp_path) -> None:
    """A torchvision-named vgg16 state dict (with ``module.`` and a classifier)
    loads; other conv layouts are refused."""
    from torch_ref import TorchVGG16Features

    torch.manual_seed(1)
    ref = TorchVGG16Features().eval()
    state = {f"module.{k}": v for k, v in ref.state_dict().items()}
    state["module.classifier.0.weight"] = torch.zeros(4, 4)
    path = tmp_path / "vgg16.pth"
    torch.save(state, path)
    extractor = preg.DFBRFeatureExtractor(patch_size=(64, 64), weights=path, device="cpu")
    image = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    with torch.inference_mode():
        want = ref(torch.from_numpy(image).permute(2, 0, 1)[None].float() / 255)
    for g, w in zip(extractor(image), want):
        assert np.abs(g - w[0].permute(1, 2, 0).numpy()).max() <= FEATURE_TOL * float(w.abs().max())
    vgg19 = {k.replace("features.28.", "features.34."): v for k, v in ref.state_dict().items()}
    with pytest.raises(ValueError, match="Not a torchvision vgg16 checkpoint"):
        torchvision_vgg16_features(vgg19)


def test_extractor_npz_and_warning(tmp_path, vgg_variables, port_warnings) -> None:
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(vgg_variables)}
    np.savez(tmp_path / "vgg.npz", **flat)
    image = np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    got = preg.DFBRFeatureExtractor(patch_size=(32, 32), weights=tmp_path / "vgg.npz", device="cpu")(image)
    want = FlaxVGG16Features().apply(vgg_variables, jnp.asarray(image[None], jnp.float32) / 255.0)
    for g, w in zip(got, want):
        assert np.abs(g - np.asarray(w[0])).max() <= FEATURE_TOL * float(np.abs(w).max())
    preg.DFBRFeatureExtractor(patch_size=(32, 32), device="cpu")
    assert any("no VGG16 weights given" in m for m in port_warnings)


def seeded_features(seed: int, sizes=((28, 28, 256), (14, 14, 512), (7, 7, 512))) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [np.maximum(rng.normal(size=s), 0).astype(np.float32) for s in sizes]


@pytest.mark.parametrize("initializer", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_dfbr_equals_jax_from_the_same_features(pair, seed, initializer) -> None:
    fixed, moving, *_ = pair
    fixed_feats = seeded_features(seed)
    # the moving features: the fixed ones shifted by a cell, with noise
    moving_feats = [np.roll(f, (1, -1), axis=(0, 1)) + 0.05 * g for f, g in zip(fixed_feats, seeded_features(seed + 50))]
    init = np.array([[1, 0, 3.0], [0, 1, -2.0], [0, 0, 1]]) if initializer else None
    results = []
    for module in (preg, jreg):
        reg = module.DFBRegister.__new__(module.DFBRegister)
        reg.patch_size = (224, 224)
        calls = iter((fixed_feats, moving_feats))
        reg._features = lambda img, calls=calls: next(calls)
        matched = reg._match_features(fixed_feats, moving_feats)
        results.append((matched, reg.register(fixed, moving, transform_initializer=init)))
    (p_match, p_transform), (j_match, j_transform) = results
    for g, w in zip(p_match, j_match):
        assert np.array_equal(g, w)
    assert np.array_equal(p_transform, j_transform)


def test_dfbr_register_recovers_translation_on_the_cpu() -> None:
    """JAX's DFBR test case through the port on the CPU (seeded VGG16)."""
    fixed = synthetic_he_patch((256, 256), seed=9)
    shift = np.array([[1, 0, 12.0], [0, 1, -8.0], [0, 0, 1]])
    moving = cv2.warpAffine(fixed, np.linalg.inv(shift)[:2], (256, 256), borderValue=(243, 243, 243))
    transform = preg.DFBRegister(patch_size=(224, 224), device="cpu").register(fixed, moving)
    assert abs(transform[0, 2] - shift[0, 2]) < 16 and abs(transform[1, 2] - shift[1, 2]) < 16
    assert np.allclose(transform[:2, :2], np.eye(2), atol=0.2)


def test_static_dfbr_helpers_equal_jax() -> None:
    rng = np.random.default_rng(4)
    dist = rng.random((30, 40))
    for g, w in zip(preg.DFBRegister.finding_match(dist), jreg.DFBRegister.finding_match(dist)):
        assert np.array_equal(g, w)
    a, b = rng.uniform(0, 100, (12, 2)), rng.uniform(0, 100, (12, 2))
    assert np.array_equal(preg.DFBRegister.estimate_affine_transform(a, b), jreg.DFBRegister.estimate_affine_transform(a, b))
    mask = rng.random((20, 20)) > 0.5
    points = rng.uniform(-5, 25, (40, 2))
    assert np.array_equal(
        preg.DFBRegister.find_points_inside_boundary(mask, points), jreg.DFBRegister.find_points_inside_boundary(mask, points)
    )


# -- the B-spline step ------------------------------------------------------------


@pytest.mark.parametrize(("grid", "image"), [((5, 7), (97, 143)), ((4, 4), (96, 96)), ((32, 42), (1536, 2048)),
                                             ((6, 5), (4, 3)), ((9, 4), (7, 40))])
def test_dense_field_weights_against_jax_resize(grid, image) -> None:
    control = np.random.default_rng(grid[0]).normal(0, 2, (*grid, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(control), (*image, 2), method="cubic"))
    wy = torch.from_numpy(preg.cubic_resize_weights(grid[0], image[0]))
    wx = torch.from_numpy(preg.cubic_resize_weights(grid[1], image[1]))
    got = preg.dense_field(torch.from_numpy(control), wy, wx).numpy()
    assert np.abs(got - want).max() <= FIELD_WEIGHT_TOL * np.abs(want).max()


def test_adam_step_equals_optax() -> None:
    rng = np.random.default_rng(8)
    params = rng.normal(size=(6, 7, 2)).astype(np.float32)
    optimizer = optax.adam(0.5)
    state = optimizer.init(jnp.asarray(params))
    j_params = jnp.asarray(params)
    control = torch.from_numpy(params.copy())
    mu, nu = torch.zeros_like(control), torch.zeros_like(control)
    for count in range(1, 4):
        grad = (rng.normal(size=params.shape) * 10.0 ** rng.integers(-9, 1, params.shape)).astype(np.float32)
        updates, state = optimizer.update(jnp.asarray(grad), state)
        j_params = optax.apply_updates(j_params, updates)
        control, mu, nu = preg.adam_step(control, torch.from_numpy(grad), mu, nu, count, 0.5)
        assert np.abs(control.numpy() - np.asarray(j_params)).max() <= ADAM_TOL


def sample_like_jax(image: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    return np.asarray(jax.scipy.ndimage.map_coordinates(jnp.asarray(image), [jnp.asarray(ys), jnp.asarray(xs)],
                                                        order=1, mode="nearest"))


def test_sample_linear_nearest_and_its_gradient_equal_jax() -> None:
    rng = np.random.default_rng(2)
    image = rng.random((30, 40)).astype(np.float32)
    ys = rng.uniform(-4, 34, (25, 20)).astype(np.float32)
    xs = rng.uniform(-4, 44, (25, 20)).astype(np.float32)
    y_t, x_t = torch.from_numpy(ys).requires_grad_(), torch.from_numpy(xs).requires_grad_()
    got = preg.sample_linear_nearest(torch.from_numpy(image), y_t, x_t)
    assert np.abs(got.detach().numpy() - sample_like_jax(image, ys, xs)).max() <= 1e-6
    got.sum().backward()
    gy, gx = jax.grad(lambda a, b: jax.scipy.ndimage.map_coordinates(jnp.asarray(image), [a, b], order=1,
                                                                     mode="nearest").sum(), argnums=(0, 1))(ys, xs)
    assert np.abs(y_t.grad.numpy() - np.asarray(gy)).max() <= 1e-5
    assert np.abs(x_t.grad.numpy() - np.asarray(gx)).max() <= 1e-5


@pytest.fixture(scope="module")
def bspline_pair():
    """JAX's B-spline test case: a 96^2 patch and its (4, 3) px shift."""
    fixed = cv2.resize(synthetic_he_patch((128, 128), seed=3), (96, 96))
    shift = np.float32([[1, 0, 4], [0, 1, 3]])
    moving = cv2.warpAffine(fixed, shift, (96, 96), borderValue=(255, 255, 255))
    return fixed, moving


def test_estimate_bspline_transform_equals_jax(bspline_pair) -> None:
    fixed, moving = bspline_pair
    want = jreg.estimate_bspline_transform(fixed, moving, n_iterations=80, grid_space=24)
    got = preg.estimate_bspline_transform(fixed, moving, n_iterations=80, grid_space=24, device="cpu")
    assert got.shape == (96, 96, 2) and got.dtype == np.float32
    assert np.abs(got - want).max() <= BSPLINE_TOL_PX
    grey_fixed = cv2.cvtColor(fixed, cv2.COLOR_RGB2GRAY).astype(float)
    grey_moving = cv2.cvtColor(moving, cv2.COLOR_RGB2GRAY).astype(float)
    warped = preg.apply_bspline_transform(fixed, grey_moving, got).astype(float)
    assert np.abs(warped - grey_fixed).mean() < np.abs(grey_moving - grey_fixed).mean()


def test_estimate_bspline_masks_and_resize_equal_jax(bspline_pair) -> None:
    """Masks (the moving one at another size: nearest resize) and a moving
    image of another size (linear resize in float64)."""
    fixed, moving = bspline_pair
    moving = cv2.resize(moving, (80, 88))
    fixed_mask = (cv2.cvtColor(fixed, cv2.COLOR_RGB2GRAY) < 230).astype(np.uint8)
    moving_mask = (cv2.cvtColor(moving, cv2.COLOR_RGB2GRAY) < 230).astype(np.uint8)
    args = (fixed, moving, fixed_mask, moving_mask, 32.0, 12)
    want = jreg.estimate_bspline_transform(*args)
    got = preg.estimate_bspline_transform(*args, device="cpu")
    assert np.abs(got - want).max() <= BSPLINE_TOL_PX


@pytest.mark.parametrize("kind", ["rgb", "grey_float", "resized"])
def test_apply_bspline_transform_equals_jax(bspline_pair, kind) -> None:
    fixed, moving = bspline_pair
    field = np.random.default_rng(6).normal(0, 3, (96, 96, 2)).astype(np.float32)
    if kind == "grey_float":
        moving = cv2.cvtColor(moving, cv2.COLOR_RGB2GRAY).astype(float)
    elif kind == "resized":
        moving = cv2.resize(moving, (70, 110))
    want = jreg.apply_bspline_transform(fixed, moving, field)
    assert np.array_equal(preg.apply_bspline_transform(fixed, moving, field), want)


def test_entry_points_raise_without_a_card(bspline_pair) -> None:
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests cover the default device")
    fixed, moving = bspline_pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preg.DFBRegister(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preg.DFBRFeatureExtractor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preg.estimate_bspline_transform(fixed, moving, n_iterations=1)


# -- reads through a transform ----------------------------------------------------


@pytest.fixture(scope="module")
def slide_path(tmp_path_factory):
    """A two-level deflate TIFF both packages read."""
    image = synthetic_he_patch((256, 320), seed=2)
    path = tmp_path_factory.mktemp("transformed") / "moving.tiff"
    TiffPyramidWriter(path, tile_size=64, mpp=(0.5, 0.5), compression="deflate").write([image, image[::2, ::2].copy()])
    return path


def rotation_3x3(angle: float, centre=(160.0, 128.0), shift=(5.5, -3.25)) -> np.ndarray:
    m = np.vstack([cv2.getRotationMatrix2D(centre, angle, 1.0), [0, 0, 1]])
    m[:2, 2] += shift
    return m


READS = {
    "identity": (np.eye(3), ((10, 10), (32, 32)), {}),
    "rotated": (rotation_3x3(17.0), ((40, 30), (150, 120)), {}),
    "rotated_level1": (rotation_3x3(-25.0), ((0, 0), (100, 80)), {"resolution": 1, "units": "level"}),
    "field_shift": ("shift", ((40, 40), (64, 48)), {}),
    "field_random": ("random", ((20, 10), (200, 150)), {}),
    "field_level1": ("random", ((0, 0), (120, 100)), {"resolution": 1, "units": "level"}),
}


def make_transform(kind):
    if isinstance(kind, np.ndarray):
        return kind
    field = np.zeros((128, 160, 2), np.float32)  # half the slide's frame: auto-scaled
    if kind == "shift":
        field[..., 0] = 5.0
    else:
        field += np.random.default_rng(9).normal(0, 2, field.shape).astype(np.float32)
    return field


@pytest.mark.parametrize("name", sorted(READS))
def test_transformed_reader_equals_jax(slide_path, name) -> None:
    kind, (location, size), kwargs = READS[name]
    transform = make_transform(kind)
    got = pstore.TransformedWSIReader(slide_path, transform).read_rect(location, size, **kwargs)
    want = jstore.TransformedWSIReader(slide_path, transform).read_rect(location, size, **kwargs)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_transformed_reader_identity_is_the_plain_read(slide_path) -> None:
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    plain = WSIReader.open(slide_path).read_rect((17, 23), (130, 90))
    assert np.array_equal(pstore.TransformedWSIReader(slide_path, np.eye(3)).read_rect((17, 23), (130, 90)), plain)


def test_transformed_reader_fixed_frame_equals_jax(slide_path) -> None:
    """A fixed frame larger than the moving slide: the field spans the
    max(moving, fixed) frame and the moving slide is centred (JAX :207-239)."""
    dims = {"slide_dimensions": (360, 290), "level_dimensions": [(360, 290)], "level_downsamples": [1.0], "axes": "YXS"}
    field = np.random.default_rng(1).normal(0, 1.5, (290, 360, 2)).astype(np.float32)
    got = pstore.TransformedWSIReader(slide_path, field, fixed_info=WSIMeta(**dims))
    want = jstore.TransformedWSIReader(slide_path, field, fixed_info=JaxWSIMeta(**dims))
    assert got.info.slide_dimensions == (360, 290)
    assert np.array_equal(got.read_rect((30, 25), (200, 160)), want.read_rect((30, 25), (200, 160)))


def test_transform_geometry_helpers_equal_jax(slide_path) -> None:
    transform = rotation_3x3(28.0)
    points = np.random.default_rng(3).uniform(0, 300, (10, 2))
    P, J = pstore.TransformedWSIReader, jstore.TransformedWSIReader
    assert np.array_equal(P.transform_points(points, transform), J.transform_points(points, transform))
    assert P.get_patch_dimensions((100, 60), transform) == J.get_patch_dimensions((100, 60), transform)
    got = P(slide_path, transform).get_transformed_location((12, 30), (100, 60))
    assert got == J(slide_path, transform).get_transformed_location((12, 30), (100, 60))
    with pytest.raises(ValueError, match="requires an affine"):
        P(slide_path, make_transform("shift")).get_transformed_location((0, 0), (4, 4))
