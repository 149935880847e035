"""The port's SAM against JAX's, which runs transformers' ``SamModel`` and ``SamProcessor``.

Tiny checkpoints (width 64, 2 layers, one global, a token grid the window
does not divide, so the window padding runs; the processor's longest edge
and pad size set to the model's input) are written by transformers'
``save_pretrained`` and loaded by both packages' ``SAM(dir)``: JAX's
through transformers, the port's through its own safetensors reader. The
same seeded images (portrait and landscape, smaller and larger than the
pad size) and prompts (a point, several points, a box as nested lists, a
point and a box) give the low-resolution logits and IoU scores within
1e-4, and the same masks except where JAX's upscaled logit is within 1e-3
of 0. One ViT-B (``SamConfig()``) image goes through both with the state
dict carried in memory. Also: a batch of images, the first prompt batch
only, numpy boxes (which JAX's processor refuses), the 315 state-dict
names loaded strictly, the checkpoint files and settings, the hub-cache
lookup and the missing checkpoint.
"""

from __future__ import annotations

import json
import os

os.environ.setdefault("USE_TF", "0")  # transformers imports TensorFlow otherwise
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from transformers import SamConfig as HFSamConfig  # noqa: E402
from transformers import SamImageProcessor, SamModel, SamProcessor  # noqa: E402

from tiatoolbox_tpu.models.architecture.sam import SAM as JaxSAM  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.sam import (  # noqa: E402
    SAM,
    SamNet,
    build_sam_net,
    resolve_checkpoint,
    save_sam_checkpoint,
    seeded_sam_state,
)
from tiatoolbox_tpu_torch.models.architecture.sam_config import (  # noqa: E402
    PreprocessorConfig,
    SamConfig,
    preprocessor_config_from_dict,
    read_preprocessor_config,
    read_sam_config,
    sam_config_from_dict,
)
from tiatoolbox_tpu_torch.models.architecture.weight_converter import (  # noqa: E402
    load_sam_checkpoint,
    sam_state_dict_from_numpy,
)
from tiatoolbox_tpu_torch.utils.safetensors_lite import (  # noqa: E402
    load_checkpoint_file,
    load_safetensors,
    save_safetensors,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

LOGIT_TOL = 1e-4
MASK_BAND = 1e-3  # masks may differ only where JAX's upscaled logit is this close to 0

# tiny configurations: (vision, prompt encoder, mask decoder) settings
TINY = {
    # a 10x10 token grid in windows of 4 (padded to 12), the global layer last
    "grid10_win4": (
        {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2, "global_attn_indexes": [1],
         "window_size": 4, "image_size": 160, "output_channels": 32, "num_pos_feats": 16},
        {"hidden_size": 32, "image_size": 160},
        {"hidden_size": 32, "mlp_dim": 64, "num_attention_heads": 2, "iou_head_hidden_dim": 32},
    ),
    # a 14x14 grid in windows of 5 (padded to 15), the global layer first
    "grid14_win5": (
        {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "global_attn_indexes": [0],
         "window_size": 5, "image_size": 224, "output_channels": 32, "num_pos_feats": 16},
        {"hidden_size": 32, "image_size": 224},
        {"hidden_size": 32, "mlp_dim": 48, "num_attention_heads": 4, "iou_head_hidden_dim": 24},
    ),
}
# (h, w) as fractions of the model's input side
SIZES = {
    "portrait_small": (0.7, 0.45),
    "landscape_small": (0.5, 0.9),
    "portrait_large": (1.9, 1.2),
    "landscape_large": (1.1, 2.3),
}
# prompts as fractions of (w, h)
PROMPTS = {
    "point": {"points": [[0.4, 0.55]]},
    "points": {"points": [[0.2, 0.3], [0.6, 0.7], [0.8, 0.25]]},
    "box": {"boxes": [[0.1, 0.2, 0.7, 0.9]]},
    "point_box": {"points": [[0.5, 0.5]], "boxes": [[0.25, 0.2, 0.75, 0.85]]},
}


def hf_config(name: str) -> HFSamConfig:
    vision, prompt, decoder = TINY[name]
    return HFSamConfig(vision_config=vision, prompt_encoder_config=prompt, mask_decoder_config=decoder)


def write_checkpoint(directory, config: HFSamConfig, seed: int):
    """``save_pretrained`` of a seeded ``SamModel`` and its ``SamProcessor``."""
    side = config.vision_config.image_size
    state = seeded_sam_state(sam_config_from_dict(config.to_dict()), seed=seed)
    model = SamModel(config)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    model.save_pretrained(directory)
    processor = SamImageProcessor(size={"longest_edge": side}, pad_size={"height": side, "width": side})
    SamProcessor(processor).save_pretrained(directory)
    return directory


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> dict:
    """Per tiny configuration: JAX's and the port's SAM over one directory."""
    out = {}
    for i, name in enumerate(TINY):
        directory = write_checkpoint(tmp_path_factory.mktemp(name), hf_config(name), seed=10 + i)
        out[name] = (JaxSAM(str(directory)), SAM(directory, device="cpu"), directory)
    return out


def image_and_prompts(side: int, size: str, prompt: str, seed: int):
    fh, fw = SIZES[size]
    h, w = round(fh * side), round(fw * side)
    image = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    spec = PROMPTS[prompt]
    points = [[round(x * w), round(y * h)] for x, y in spec["points"]] if "points" in spec else None
    boxes = [[round(b[0] * w), round(b[1] * h), round(b[2] * w), round(b[3] * h)] for b in spec["boxes"]] if "boxes" in spec else None
    return image, points, boxes


def jax_outputs(jsam: JaxSAM, image: np.ndarray, points, boxes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JAX's model outputs for one image, its processor called as its
    ``infer_batch`` calls it (``sam.py:61-72``): the low-resolution logits,
    the IoU scores and the upscaled logits of the first prompt batch."""
    inputs = jsam.processor(
        image,
        input_points=[[points]] if points else None,
        input_boxes=[[boxes]] if boxes else None,
        return_tensors="pt",
    )
    with torch.inference_mode():
        outputs = jsam.model(**inputs)
    up = jsam.processor.image_processor.post_process_masks(
        outputs.pred_masks, inputs["original_sizes"], inputs["reshaped_input_sizes"], binarize=False
    )
    return outputs.pred_masks[0].numpy(), outputs.iou_scores[0].numpy(), up[0][0].numpy()


def assert_masks_match(port_mask: np.ndarray, jax_mask: np.ndarray, jax_logits: np.ndarray) -> None:
    assert port_mask.shape == jax_mask.shape and port_mask.dtype == jax_mask.dtype == bool
    differ = port_mask != jax_mask
    assert not (differ & (np.abs(jax_logits) > MASK_BAND)).any()


@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("config", list(TINY))
def test_tiny_sam_matches_jax(tiny, config, size, prompt) -> None:
    jsam, psam, _ = tiny[config]
    side = TINY[config][0]["image_size"]
    image, points, boxes = image_and_prompts(side, size, prompt, seed=len(size) + 7 * len(prompt))
    low, iou, up = jax_outputs(jsam, image, points, boxes)
    got = psam.infer_logits([image], [points] if points else None, [boxes] if boxes else None)[0]
    np.testing.assert_allclose(got["low_res_masks"].numpy(), low, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got["iou_scores"].numpy(), iou, rtol=0, atol=LOGIT_TOL)
    assert got["original_size"] == image.shape[:2]
    batch = image[None]
    pc = [points] if points else None
    bc = [boxes] if boxes else None
    jax_mask = jsam.infer_batch(batch, point_coords=pc, box_coords=bc)[0]
    port_mask = psam.infer_batch(batch, point_coords=pc, box_coords=bc)[0]
    assert port_mask.shape == (3, *image.shape[:2])
    assert_masks_match(port_mask, jax_mask, up)


def test_batch_of_images_matches_jax_loop(tiny) -> None:
    """Five images in one call (the encoder takes them four at a time), with
    per-image points, against JAX's loop over the images."""
    jsam, psam, _ = tiny["grid10_win4"]
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (5, 130, 95, 3), dtype=np.uint8)
    points = rng.integers(5, 90, (5, 2, 2))
    jax_masks = jsam.infer_batch(images, point_coords=points)
    port_masks = psam.infer_batch(images, point_coords=points)
    for i, (got, want) in enumerate(zip(port_masks, jax_masks)):
        assert_masks_match(got, want, jax_outputs(jsam, images[i], points[i].tolist(), None)[2])


def test_numpy_boxes_which_jax_refuses(tiny) -> None:
    """The tile server passes ``box_coords`` as a numpy array
    (``tileserver.py:677-686``); JAX's processor refuses it, the port gives
    the nested lists' masks."""
    jsam, psam, _ = tiny["grid10_win4"]
    image = np.random.default_rng(4).integers(0, 256, (1, 120, 150, 3), dtype=np.uint8)
    boxes = np.array([[[20, 15, 110, 100]]])
    with pytest.raises(ValueError, match="Input boxes must be a list of list of list"):
        jsam.infer_batch(image, box_coords=boxes)
    from_array = psam.infer_batch(image, box_coords=boxes)[0]
    from_lists = psam.infer_batch(image, box_coords=boxes.tolist())[0]
    np.testing.assert_array_equal(from_array, from_lists)
    _, _, up = jax_outputs(jsam, image[0], None, boxes[0].tolist())
    assert_masks_match(from_array, jsam.infer_batch(image, box_coords=boxes.tolist())[0], up)


def test_only_the_first_prompt_batch_is_kept(tiny) -> None:
    """Two boxes make two prompt batches; both packages keep the first
    (``masks[0][0]``, ``sam.py:78``), the masks of the first box alone."""
    jsam, psam, _ = tiny["grid14_win5"]
    image = np.random.default_rng(5).integers(0, 256, (1, 200, 180, 3), dtype=np.uint8)
    two = [[[10, 20, 120, 150], [60, 40, 170, 190]]]
    got = psam.infer_logits(image, box_coords=two)[0]
    assert got["low_res_masks"].shape[:2] == (2, 3)
    first = psam.infer_logits(image, box_coords=[two[0][:1]])[0]
    np.testing.assert_allclose(got["low_res_masks"][:1].numpy(), first["low_res_masks"].numpy(), atol=LOGIT_TOL)
    _, _, up = jax_outputs(jsam, image[0], None, two[0])
    assert_masks_match(psam.infer_batch(image, box_coords=two)[0], jsam.infer_batch(image, box_coords=two)[0], up)


def test_points_and_several_boxes_refused_by_both(tiny) -> None:
    jsam, psam, _ = tiny["grid10_win4"]
    image = np.zeros((1, 100, 100, 3), np.uint8)
    prompts = {"point_coords": [[[50, 50]]], "box_coords": [[[0, 0, 50, 50], [10, 10, 90, 90]]]}
    with pytest.raises(ValueError, match="as many bounding boxes as input points"):
        jsam.infer_batch(image, **prompts)
    with pytest.raises(ValueError, match="as many bounding boxes as input points"):
        psam.infer_batch(image, **prompts)


def test_vit_b_image_matches_jax() -> None:
    """One image through ``SamConfig()`` (ViT-B) in both packages, the
    seeded state dict carried in memory."""
    state = seeded_sam_state(SamConfig(), seed=2)
    with torch.device("meta"):
        model = SamModel(HFSamConfig())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True, assign=True)
    jsam = JaxSAM.__new__(JaxSAM)
    jsam.model = model.eval()
    jsam.processor = SamProcessor(SamImageProcessor())
    psam = SAM.__new__(SAM)
    psam.model = build_sam_net(SamConfig(), sam_state_dict_from_numpy(state), "cpu")
    psam.preprocessor = PreprocessorConfig()
    image = np.random.default_rng(6).integers(0, 256, (700, 900, 3), dtype=np.uint8)
    points, boxes = [[300, 200]], [[100, 150, 600, 500]]
    low, iou, up = jax_outputs(jsam, image, points, boxes)
    got = psam.infer_logits([image], [points], [boxes])[0]
    np.testing.assert_allclose(got["low_res_masks"].numpy(), low, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got["iou_scores"].numpy(), iou, rtol=0, atol=LOGIT_TOL)
    from tiatoolbox_tpu_torch.models.architecture.sam_processor import post_process_masks

    mask = post_process_masks(got["low_res_masks"], got["original_size"], got["reshaped_size"], psam.preprocessor)[0]
    assert_masks_match(mask.numpy(), up > 0, up)


@pytest.mark.parametrize(("q_size", "length"), [(14, 27), (14, 19), (10, 31), (5, 9), (64, 127)])
def test_get_rel_pos_as_transformers(q_size, length) -> None:
    """The relative positions of each query/key pair, interpolated where the
    table's length is not ``2 size - 1`` (a checkpoint made for another size)."""
    from transformers.models.sam.modeling_sam import SamVisionAttention

    from tiatoolbox_tpu_torch.models.architecture.sam_vision import get_rel_pos

    table = torch.from_numpy(np.random.default_rng(length).standard_normal((length, 8)).astype(np.float32))
    want = SamVisionAttention.get_rel_pos(None, q_size, q_size, table)
    assert torch.equal(get_rel_pos(q_size, q_size, table), want)


def test_state_dict_names_load_strictly() -> None:
    """The port's 315 names are transformers' ``SamModel(SamConfig())``'s;
    a missing or an extra name refuses the load."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in SamModel(HFSamConfig()).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in SamNet(SamConfig()).state_dict().items()}
    assert len(want) == 315
    assert got == want
    config = sam_config_from_dict(hf_config("grid10_win4").to_dict())
    state = sam_state_dict_from_numpy(seeded_sam_state(config, seed=1))
    net = build_sam_net(config, state, "cpu")
    assert net.prompt_encoder.shared_embedding is net.shared_image_embedding
    missing = dict(state)
    missing.pop("mask_decoder.iou_token.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        build_sam_net(config, missing, "cpu")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        build_sam_net(config, {**state, "extra.weight": torch.zeros(1)}, "cpu")


def test_checkpoint_directory_loads_as_transformers_wrote_it(tiny, tmp_path) -> None:
    """The port reads the directory's settings and weights as transformers
    does; its own writer's directory loads in transformers, the same weights."""
    jsam, psam, directory = tiny["grid14_win5"]
    config = read_sam_config(directory)
    assert config == sam_config_from_dict(jsam.model.config.to_dict())
    assert config.vision_config.global_attn_indexes == (0,)
    assert read_preprocessor_config(directory) == PreprocessorConfig(longest_edge=224, pad_height=224, pad_width=224)
    want = jsam.model.state_dict()
    got = psam.model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    written = save_sam_checkpoint(tmp_path / "port", {k: v.numpy() for k, v in got.items()}, config, read_preprocessor_config(directory))
    reloaded = SamModel.from_pretrained(written).state_dict()
    for name, value in want.items():
        assert torch.equal(reloaded[name], value), name
    assert SamProcessor.from_pretrained(written).image_processor.size == {"longest_edge": 224}
    # pytorch_model.bin instead of model.safetensors
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "config.json").write_text((directory / "config.json").read_text())
    torch.save(jsam.model.state_dict(), bin_dir / "pytorch_model.bin")
    net = load_sam_checkpoint(bin_dir, device="cpu")
    assert all(torch.equal(net.state_dict()[k], v) for k, v in want.items())


def test_safetensors_reader_against_the_library(tmp_path) -> None:
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(7)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i64": rng.integers(-9, 9, (2, 2, 2)),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    save_file(arrays, tmp_path / "a.safetensors", metadata={"format": "np"})
    got = load_safetensors(tmp_path / "a.safetensors")
    assert set(got) == set(arrays)
    for name, value in arrays.items():
        np.testing.assert_array_equal(got[name].numpy(), value)
        assert got[name].numpy().dtype == value.dtype
    bf16 = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16()
    save_torch({"bf16": bf16}, tmp_path / "b.safetensors")
    assert torch.equal(load_checkpoint_file(tmp_path / "b.safetensors")["bf16"], bf16)
    floats = {name: value for name, value in arrays.items() if value.dtype == np.float32}
    save_safetensors(floats, tmp_path / "port.safetensors")
    from safetensors.numpy import load_file

    back = load_file(tmp_path / "port.safetensors")
    assert set(back) == set(floats)
    for name, value in floats.items():
        np.testing.assert_array_equal(back[name], value)
    with pytest.raises(ValueError, match="dtype float16; the writer takes float32"):
        save_safetensors({"f16": arrays["f16"]}, tmp_path / "f16.safetensors")
    save_file({"f64": np.zeros(3)}, tmp_path / "c.safetensors")
    with pytest.raises(ValueError, match="dtype F64"):
        load_safetensors(tmp_path / "c.safetensors")


def test_unsupported_settings_raise_and_name_themselves() -> None:
    with pytest.raises(ValueError, match="resample=3"):
        preprocessor_config_from_dict({"resample": 3})
    with pytest.raises(ValueError, match="do_pad=False"):
        preprocessor_config_from_dict({"do_pad": False})
    raw = HFSamConfig().to_dict()
    raw["vision_config"]["hidden_act"] = "relu"
    with pytest.raises(ValueError, match="hidden_act='relu'"):
        sam_config_from_dict(raw)
    for switch in ("qkv_bias", "use_abs_pos", "use_rel_pos"):
        raw = HFSamConfig().to_dict()
        raw["vision_config"][switch] = False
        with pytest.raises(ValueError, match=f"{switch}=False"):
            sam_config_from_dict(raw)
    assert sam_config_from_dict(HFSamConfig().to_dict()) == SamConfig()
    assert preprocessor_config_from_dict(SamImageProcessor().to_dict()) == PreprocessorConfig()


def test_hub_id_resolves_in_the_local_cache(tiny, tmp_path, monkeypatch) -> None:
    _, psam, directory = tiny["grid10_win4"]
    snapshot = tmp_path / "hub" / "models--facebook--sam-vit-base" / "snapshots" / "0123abc"
    snapshot.mkdir(parents=True)
    for name in ("config.json", "model.safetensors", "preprocessor_config.json"):
        (snapshot / name).write_bytes((directory / name).read_bytes())
    (tmp_path / "hub" / "models--facebook--sam-vit-base" / "refs").mkdir()
    (tmp_path / "hub" / "models--facebook--sam-vit-base" / "refs" / "main").write_text("0123abc")
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert resolve_checkpoint("facebook/sam-vit-base") == snapshot
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    sam = SAM("facebook/sam-vit-base", device="cpu")
    image = np.random.default_rng(8).integers(0, 256, (1, 90, 120, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        sam.infer_batch(image, point_coords=[[[30, 40]]])[0], psam.infer_batch(image, point_coords=[[[30, 40]]])[0]
    )
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "elsewhere"))
    assert resolve_checkpoint("facebook/sam-vit-base") is None


def test_missing_checkpoint_raises_jax_message(tmp_path) -> None:
    """A directory without a checkpoint: both raise ``FileNotFoundError``
    with JAX's message (transformers looks no further than a local
    directory, so no hub is asked)."""
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError) as jax_error:
        JaxSAM(str(empty))
    with pytest.raises(FileNotFoundError) as port_error:
        SAM(str(empty), device="cpu")
    assert str(port_error.value) == str(jax_error.value)
    (empty / "config.json").write_text(json.dumps(SamConfig().to_json_dict()))
    with pytest.raises(FileNotFoundError, match="zero-egress"):
        SAM(empty, device="cpu")
    # a path that is not there, and a hub id missing from the local cache
    with pytest.raises(FileNotFoundError, match="zero-egress"):
        SAM(tmp_path / "no_such_checkpoint", device="cpu")
    assert resolve_checkpoint(tmp_path / "no_such_checkpoint") is None
