"""The port's SAM pre- and post-processing against PIL and transformers.

``resize_bilinear_u8`` equals ``PIL.Image.resize(BILINEAR)`` bit for bit:
growing and shrinking, odd sizes, 1-pixel edges, one axis at a time, and
sizes drawn by ``hypothesis``. ``preprocess`` gives ``SamImageProcessor``'s
pixel values bit for bit (float32), with its original and resized sizes;
``scale_points``/``scale_boxes`` give ``SamProcessor``'s coordinates, and
``post_process_masks``/``upscale_logits`` its masks and logits.
"""

from __future__ import annotations

import os

os.environ.setdefault("USE_TF", "0")  # transformers imports TensorFlow otherwise

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from PIL import Image  # noqa: E402
from transformers import SamImageProcessor, SamProcessor  # noqa: E402

from tiatoolbox_tpu_torch.models.architecture.sam_config import PreprocessorConfig  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.sam_processor import (  # noqa: E402
    bilinear_taps,
    post_process_masks,
    preprocess,
    preprocess_shape,
    resize_bilinear_u8,
    scale_boxes,
    scale_points,
    upscale_logits,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pil_resize(image: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    return np.asarray(Image.fromarray(image).resize((hw[1], hw[0]), Image.BILINEAR))


def assert_pil_exact(hw_in: tuple[int, int], hw_out: tuple[int, int], seed: int) -> None:
    image = np.random.default_rng(seed).integers(0, 256, (*hw_in, 3), dtype=np.uint8)
    got = resize_bilinear_u8(torch.from_numpy(image), hw_out).numpy()
    np.testing.assert_array_equal(got, pil_resize(image, hw_out))


CASES = {
    "grow": ((37, 59), (211, 300)),
    "shrink": ((300, 211), (37, 59)),
    "shrink_by_3": ((999, 600), (333, 200)),
    "sam_long_edge_down": ((1500, 1000), (1024, 683)),
    "sam_long_edge_up": ((100, 80), (1024, 819)),
    "mixed": ((64, 300), (200, 77)),
    "odd_to_odd": ((13, 17), (29, 7)),
    "one_pixel_in": ((1, 1), (5, 7)),
    "one_pixel_out": ((9, 23), (1, 1)),
    "one_row": ((1, 40), (3, 17)),
    "one_column": ((40, 1), (13, 1)),
    "width_only": ((50, 33), (50, 71)),
    "height_only": ((50, 33), (21, 33)),
    "same": ((31, 47), (31, 47)),
    "tiny_to_wide": ((2, 2), (3, 1000)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resize_equals_pil_bilinear(case) -> None:
    hw_in, hw_out = CASES[case]
    assert_pil_exact(hw_in, hw_out, seed=len(case))


@settings(max_examples=60, deadline=None)
@given(
    st.integers(1, 260), st.integers(1, 260), st.integers(1, 260), st.integers(1, 260), st.integers(0, 2**32 - 1)
)
def test_resize_equals_pil_bilinear_drawn(h, w, oh, ow, seed) -> None:
    assert_pil_exact((h, w), (oh, ow), seed)


def test_extreme_values_and_taps() -> None:
    """Saturated images stay saturated, and each output's weights sum to
    2^22 within its rounding."""
    for value in (0, 255):
        image = np.full((47, 31, 3), value, np.uint8)
        np.testing.assert_array_equal(resize_bilinear_u8(torch.from_numpy(image), (90, 13)).numpy(), pil_resize(image, (90, 13)))
    for n_in, n_out in ((1000, 7), (7, 1000), (1024, 1024)):
        _, count, weights = bilinear_taps(n_in, n_out)
        assert (count >= 1).all()
        assert np.abs(weights.sum(1) - (1 << 22)).max() <= weights.shape[1]


@pytest.mark.parametrize("hw", [(1500, 1000), (1000, 1500), (700, 900), (90, 60), (1024, 1024), (33, 1031)])
def test_preprocess_equals_sam_image_processor(hw) -> None:
    image = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = SamImageProcessor()(image, return_tensors="np")
    pixels, original, resized = preprocess(image, PreprocessorConfig(), "cpu")
    assert original == tuple(want["original_sizes"][0]) == hw
    assert resized == tuple(want["reshaped_input_sizes"][0])
    np.testing.assert_array_equal(pixels.numpy(), want["pixel_values"][0])


def test_preprocess_refuses_other_images() -> None:
    with pytest.raises(ValueError, match="uint8"):
        preprocess(np.zeros((8, 8, 3), np.float32), PreprocessorConfig(), "cpu")
    with pytest.raises(ValueError, match="uint8"):
        preprocess(np.zeros((8, 8, 4), np.uint8), PreprocessorConfig(), "cpu")


@pytest.mark.parametrize("edge", [1024, 160, 333])
def test_preprocess_shape(edge) -> None:
    processor = SamImageProcessor()
    rng = np.random.default_rng(edge)
    for h, w in [(1, 1), (1, 5000), (5000, 1), (1500, 1000), *rng.integers(1, 4000, (200, 2)).tolist()]:
        assert preprocess_shape((h, w), edge) == processor._get_preprocess_shape((h, w), edge)


@pytest.mark.parametrize("original", [(1500, 1000), (700, 901), (33, 1031), (1024, 1024)])
def test_coordinates_scaled_as_sam_processor(original) -> None:
    processor = SamProcessor(SamImageProcessor())
    points = np.array([[0, 0], [13.5, 99], [original[1] - 1, original[0] - 1]])
    boxes = np.array([[3, 4, 500, 600], [0.5, 1.25, 17, 19]])
    np.testing.assert_array_equal(
        scale_points(points, original, 1024), processor._normalize_coordinates(1024, points, original)
    )
    want = processor._normalize_coordinates(1024, boxes.astype(np.float32), original, is_bounding_box=True)
    np.testing.assert_array_equal(scale_boxes(boxes, original, 1024), want)
    np.testing.assert_array_equal(scale_boxes(boxes.tolist(), original, 1024), want)
    np.testing.assert_array_equal(scale_boxes([3, 4, 500, 600], original, 1024), want[:1])


@pytest.mark.parametrize(("original", "resized"), [((1500, 1000), (1024, 683)), ((90, 60), (1024, 683)), ((1024, 1024), (1024, 1024))])
def test_post_process_masks_as_sam_image_processor(original, resized) -> None:
    processor = SamImageProcessor()
    low = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 256, 256)).astype(np.float32))
    cfg = PreprocessorConfig()
    want = processor.post_process_masks([low.clone()], [original], [resized])[0]
    assert torch.equal(post_process_masks(low, original, resized, cfg), want)
    want_logits = processor.post_process_masks([low.clone()], [original], [resized], binarize=False)[0]
    assert torch.equal(upscale_logits(low, original, resized, cfg), want_logits)
