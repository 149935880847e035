"""The port's argparse CLI against JAX's click CLI.

The command trees are walked and compared: commands, option names,
defaults (``--device`` apart: the port's defaults to the card), ``nargs``
and choices. Then each command runs through JAX's ``CliRunner`` and the
port's in-process ``main`` (``--device cpu``) on the same slide and images,
and the outputs are compared: YAML loaded with PyYAML and as text,
thumbnails, reads, masks and tiles pixel for pixel, ``stain-norm`` within
one level (the default target goes through the stand-in synth, where the
packages part by a level in a few values), and the patch predictor and
feature extractor within 1e-4 of JAX's on the same seeded ``.pth`` under
``TIATOOLBOX_HOME/models``. ``nucleus-detector`` with SCCNN is held to the
port's engine called directly (JAX's weight converter reads only upstream
ResNet checkpoints). ``show-wsi`` serves on a thread and stops through
``/tileserver/shutdown``, and ``python -m tiatoolbox_tpu_torch.cli`` runs
in a subprocess.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import click
import cv2
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from tiatoolbox_tpu import rcParam as jax_rc
from tiatoolbox_tpu.cli import tiatoolbox_cli
from tiatoolbox_tpu_torch import rcParam as port_rc
from tiatoolbox_tpu_torch.cli import build_parser, main
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch_exact
from tiatoolbox_tpu_torch.utils.misc import imwrite
from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup

REPO = Path(__file__).resolve().parents[1]
COMMANDS = sorted(tiatoolbox_cli.commands)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    slide = tmp / "s.tiff"
    make_synthetic_slide(slide, size=(512, 384), mpp=0.5, objective_power=20, compression="deflate")
    patch = tmp / "p.png"
    imwrite(patch, synthetic_he_patch_exact((256, 256), seed=3))
    target = tmp / "t.png"
    imwrite(target, synthetic_he_patch_exact((160, 160), seed=8))
    home = tmp / "home"
    (home / "models").mkdir(parents=True)
    old = jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"]
    jax_rc["TIATOOLBOX_HOME"] = str(home)
    port_rc["TIATOOLBOX_HOME"] = home
    yield {"tmp": tmp, "slide": str(slide), "patch": str(patch), "target": str(target), "home": home}
    jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"] = old


def run_jax(*args) -> str:
    result = CliRunner().invoke(tiatoolbox_cli, list(args))
    assert result.exit_code == 0, (result.exception, result.output[-500:])
    return result.output


def run_port(capsys, *args) -> str:
    capsys.readouterr()
    assert main(list(args)) == 0
    return capsys.readouterr().out


def both(capsys, tmp: Path, name: str, *args) -> tuple[Path, Path]:
    """Run one command in both packages, each into its own output path."""
    jax_out, port_out = tmp / f"jax_{name}", tmp / f"port_{name}"
    run_jax(*args, "--output-path", str(jax_out))
    run_port(capsys, *args, "--output-path", str(port_out))
    return jax_out, port_out


def png(path: Path) -> np.ndarray:
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


# -- the command tree ---------------------------------------------------------


def click_options(command: click.Command) -> dict:
    out = {}
    for param in command.params:
        if not isinstance(param, click.Option):
            continue
        choices = list(param.type.choices) if isinstance(param.type, click.Choice) else None
        nargs = 2 if isinstance(param.type, click.Tuple) else param.nargs
        default = param.default
        if repr(default) == "Sentinel.UNSET":  # click 8.3+: no default given, the value is None
            default = None
        if isinstance(default, list):
            default = tuple(default)
        out[param.name] = {
            "flags": sorted(param.opts + param.secondary_opts),
            "default": default,
            "nargs": nargs,
            "choices": choices,
        }
    return out


def argparse_options(parser) -> dict:
    out: dict = {}
    for action in parser._actions:  # noqa: SLF001
        if action.dest == "help":
            continue
        entry = out.setdefault(action.dest, {"flags": [], "default": action.default,
                                             "nargs": 2 if action.nargs == 2 else 1,
                                             "choices": list(action.choices) if action.choices else None})
        entry["flags"] = sorted(entry["flags"] + list(action.option_strings))
    return out


def test_fifteen_commands() -> None:
    parser = build_parser()
    assert len(COMMANDS) == 15
    assert sorted(parser.commands.choices) == COMMANDS


@pytest.mark.parametrize("name", COMMANDS)
def test_command_options_match_click(name: str) -> None:
    want = click_options(tiatoolbox_cli.commands[name])
    got = argparse_options(build_parser().commands.choices[name])
    assert sorted(got) == sorted(want)
    for dest, spec in want.items():
        mine = dict(got[dest])
        if dest == "device":
            assert spec["default"] == "cpu"
            assert mine["default"] == "cuda"
            mine["default"] = spec["default"]
        assert mine == spec, dest


def test_device_refused_by_name(capsys) -> None:
    with pytest.raises(SystemExit) as err:
        main(["patch-predictor", "--device", "tpu"])
    assert err.value.code == 2
    assert "unknown device 'tpu'" in capsys.readouterr().err
    parsed = build_parser().parse_args(["patch-predictor", "--device", "cuda:1"])
    assert parsed.device == "cuda:1"


@pytest.mark.parametrize(
    "args",
    [
        ["tissue-mask", "--method", "otsu"],
        ["stain-norm", "--method", "bogus"],
        ["patch-predictor", "--mode", "stack"],
        ["patch-predictor", "--input-resolutions", "{not json"],
        ["patch-predictor", "--return-probabilities", "maybe"],
        ["save-tiles", "--tile-read-size", "5"],
        ["no-such-command"],
    ],
)
def test_usage_errors_exit_two_in_both(args, capsys) -> None:
    assert CliRunner().invoke(tiatoolbox_cli, args).exit_code == 2
    with pytest.raises(SystemExit) as err:
        main(args)
    assert err.value.code == 2
    if "--input-resolutions" in args:
        assert "must be valid JSON" in capsys.readouterr().err


def test_click_values_parse_alike() -> None:
    """Tuples for nargs=2, click's booleans, JSON values and int class keys."""
    parser = build_parser()
    ns = parser.parse_args(
        ["nucleus-detector", "--scale-factor", "0.5", "2", "--return-predictions", "Yes",
         "--overwrite", "off", "--class-dict", '{"0": "bg", "x": 1}', "--postproc-tile-shape", "64", "32",
         "--quiet"]
    )
    assert ns.scale_factor == [0.5, 2.0]
    assert ns.return_predictions is True and ns.overwrite is False and ns.verbose is False
    assert ns.class_dict == {0: "bg", "x": 1}
    ctx = tiatoolbox_cli.commands["nucleus-detector"].make_context(
        "nucleus-detector",
        ["--scale-factor", "0.5", "2", "--return-predictions", "Yes", "--overwrite", "off",
         "--class-dict", '{"0": "bg", "x": 1}', "--postproc-tile-shape", "64", "32", "--quiet"],
    )
    assert ctx.params["scale_factor"] == (0.5, 2.0)
    assert ctx.params["class_dict"] == ns.class_dict
    assert ctx.params["return_predictions"] is True and ctx.params["overwrite"] is False


# -- the commands' outputs ---------------------------------------------------


def test_slide_info(data, capsys) -> None:
    jax_show = run_jax("slide-info", "--img-input", data["slide"], "--mode", "show")
    port_show = run_port(capsys, "slide-info", "--img-input", data["slide"], "--mode", "show")
    assert json.loads(port_show.split("Processed")[0]) == json.loads(jax_show.split("Processed")[0])
    jax_out, port_out = both(capsys, data["tmp"], "info", "slide-info", "--img-input", data["slide"], "--mode", "save")
    jax_text = (jax_out / "s.yaml").read_text()
    port_text = (port_out / "s.yaml").read_text()
    assert yaml.safe_load(port_text) == yaml.safe_load(jax_text)
    assert port_text == jax_text


def test_slide_thumbnail(data, capsys) -> None:
    jax_out, port_out = both(capsys, data["tmp"], "thumb", "slide-thumbnail", "--img-input", data["slide"])
    np.testing.assert_array_equal(png(port_out / "s_thumb.png"), png(jax_out / "s_thumb.png"))


@pytest.mark.parametrize(
    ("region", "resolution", "units", "suffix"),
    [("0,0,128,96", "0", "level", ".png"), ("40,30,300,250", "1.0", "mpp", ".jpg"), (None, "0", "level", ".png")],
)
def test_read_bounds(data, capsys, region, resolution, units, suffix) -> None:
    args = ["read-bounds", "--img-input", data["slide"], "--resolution", resolution, "--units", units]
    if region:
        args += ["--region", region]
    jax_path = data["tmp"] / f"jax_rb_{units}{suffix}"
    port_path = data["tmp"] / f"port_rb_{units}{suffix}"
    run_jax(*args, "--output-path", str(jax_path))
    run_port(capsys, *args, "--output-path", str(port_path))
    if suffix == ".jpg":  # the port's JPEG encoder writes cv2's bytes
        assert port_path.read_bytes() == jax_path.read_bytes()
    np.testing.assert_array_equal(png(port_path), png(jax_path))


@pytest.mark.parametrize("method", ["Otsu", "Morphological"])
def test_tissue_mask(data, capsys, method) -> None:
    jax_out, port_out = both(capsys, data["tmp"], f"mask_{method}", "tissue-mask", "--img-input", data["slide"],
                             "--method", method, "--resolution", "5", "--units", "power")
    np.testing.assert_array_equal(png(port_out / "s_mask.png"), png(jax_out / "s_mask.png"))


def test_save_tiles(data, capsys) -> None:
    jax_out, port_out = both(capsys, data["tmp"], "tiles", "save-tiles", "--img-input", data["slide"],
                             "--tile-objective-value", "10", "--tile-read-size", "200", "150")
    jax_files = sorted(p.name for p in (jax_out / "s.tiff").iterdir())
    port_files = sorted(p.name for p in (port_out / "s.tiff").iterdir())
    assert port_files == jax_files and len(jax_files) == 2 * 2 + 2
    for name in jax_files:  # JPEG tiles and thumbnail: cv2's bytes; the csv as text
        assert (port_out / "s.tiff" / name).read_bytes() == (jax_out / "s.tiff" / name).read_bytes(), name


@pytest.mark.parametrize("method", ["reinhard", "macenko", "ruifrok", "vahadane", "custom"])
@pytest.mark.parametrize("target", ["default", "file"])
def test_stain_norm(data, capsys, method, target) -> None:
    args = ["stain-norm", "--img-input", data["patch"], "--method", method]
    if target == "file":
        args += ["--target-input", data["target"]]
    if method == "custom":
        matrix = data["tmp"] / "stain.npy"
        np.save(matrix, np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]]))
        args += ["--stain-matrix", str(matrix)]
    jax_out, port_out = both(capsys, data["tmp"], f"sn_{method}_{target}", *args)
    got = png(port_out / "p_normalized.png").astype(int)
    want = png(jax_out / "p_normalized.png").astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


# -- engine commands -----------------------------------------------------------


@pytest.fixture(scope="module")
def seeded_checkpoints(data):
    """Seeded ``.pth`` state dicts under ``TIATOOLBOX_HOME/models``, which both packages load."""
    from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel

    torch.manual_seed(0)
    for name, model in (
        ("resnet18-kather100k", CNNModel("resnet18", num_classes=9, device="cpu")),
        ("resnet50-kather100k", CNNModel("resnet50", num_classes=9, device="cpu")),
    ):
        state = model.state_dict()
        # batch norms off the identity, so outputs depend on the input
        for key, value in state.items():
            if key.endswith("running_var"):
                value.uniform_(0.5, 2.0)
            elif key.endswith("running_mean"):
                value.uniform_(-0.2, 0.2)
        torch.save(state, data["home"] / "models" / f"{name}.pth")
    return data


def read_zarr(path: Path) -> dict:
    group = ZarrGroup(path)
    return {key: np.asarray(group[key][:]) for key in group.keys()}


@pytest.mark.parametrize("mode", ["wsi", "tile"])
def test_patch_predictor_against_jax(seeded_checkpoints, capsys, mode) -> None:
    data = seeded_checkpoints
    img = data["slide"] if mode == "wsi" else data["patch"]
    args = ["patch-predictor", "--img-input", img, "--mode", mode, "--batch-size", "4",
            "--return-probabilities", "true", "--output-type", "zarr", "--quiet"]
    jax_out, port_out = both(capsys, data["tmp"], f"pp_{mode}", *args, "--device", "cpu")
    stem = Path(img).stem
    got = read_zarr(port_out / "raw" / f"{stem}.zarr")
    want = read_zarr(jax_out / "raw" / f"{stem}.zarr")
    assert len(want["probabilities"]) > 0
    np.testing.assert_array_equal(got["coordinates"], want["coordinates"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=1e-4)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])


def test_feature_extractor_against_jax(seeded_checkpoints, capsys) -> None:
    data = seeded_checkpoints
    args = ["deep-feature-extractor", "--img-input", data["patch"], "--mode", "tile", "--batch-size", "4",
            "--output-type", "zarr", "--quiet", "--device", "cpu"]
    jax_out, port_out = both(capsys, data["tmp"], "dfe", *args)
    got = read_zarr(port_out / "raw" / "p.zarr")
    want = read_zarr(jax_out / "raw" / "p.zarr")
    np.testing.assert_array_equal(got["coordinates"], want["coordinates"])
    scale = float(np.abs(want["features"]).max())
    np.testing.assert_allclose(got["features"], want["features"], atol=1e-4 * scale)


def test_detector_command_equals_port_engine(data, capsys) -> None:
    """SCCNN through the command and through ``NucleusDetector`` called directly."""
    from tiatoolbox_tpu_torch.models.architecture.sccnn import SCCNN
    from tiatoolbox_tpu_torch.models.engine.nucleus_detector import NucleusDetector

    torch.manual_seed(1)
    torch.save(SCCNN(device="cpu").state_dict(), data["home"] / "models" / "sccnn-crchisto.pth")
    small = data["tmp"] / "small.png"
    imwrite(small, synthetic_he_patch_exact((96, 80), seed=5))
    out = data["tmp"] / "det"
    run_port(capsys, "nucleus-detector", "--img-input", str(small), "--mode", "tile", "--device", "cpu",
             "--pretrained-model", "sccnn-crchisto", "--batch-size", "64", "--output-type", "zarr",
             "--threshold-abs", "0.3", "--min-distance", "3", "--quiet", "--output-path", str(out))
    engine = NucleusDetector("sccnn-crchisto", batch_size=64, verbose=False, device="cpu")
    direct = engine.run([str(small)], patch_mode=False, ioconfig=engine.ioconfig.to_baseline(), output_type="zarr",
                        save_dir=data["tmp"] / "det_direct", threshold_abs=0.3, min_distance=3, memory_threshold=80)
    got = read_zarr(out / "raw" / "small.zarr")
    want = read_zarr(Path(direct[str(small)]))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_yaml_config_path_read_by_port(data, capsys) -> None:
    cfg = data["tmp"] / "io.yaml"
    cfg.write_text(
        "# io config\ninput_resolutions:\n- {units: mpp, resolution: 0.5}\n"
        "patch_input_shape: [96, 96]   # square\nstride_shape:\n  - 96\n  - 96\n"
    )
    from tiatoolbox_tpu.cli.common import load_yaml_ioconfig as jax_load
    from tiatoolbox_tpu_torch.cli.common import load_yaml_ioconfig as port_load

    got, want = port_load(cfg), jax_load(cfg)
    assert type(got).__name__ == type(want).__name__
    assert got.input_resolutions == want.input_resolutions
    assert list(got.patch_input_shape) == list(want.patch_input_shape)
    assert list(got.stride_shape) == list(want.stride_shape)


# -- the server command and the module entry ---------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_show_wsi_serves_and_shuts_down(data, capsys) -> None:
    port = free_port()
    thread = threading.Thread(
        target=main, args=(["show-wsi", "--img-input", data["slide"], "--port", str(port)],), daemon=True
    )
    thread.start()
    url = f"http://127.0.0.1:{port}/tileserver"
    for _ in range(100):
        try:
            with urllib.request.urlopen(f"{url}/healthcheck", timeout=5) as resp:
                assert json.loads(resp.read()) == {"status": "OK"}
            break
        except OSError:
            time.sleep(0.05)
    else:
        pytest.fail("show-wsi did not answer")
    with urllib.request.urlopen(f"{url}/layers", timeout=5) as resp:
        assert json.loads(resp.read()) == {"layers": ["slide"]}
    with urllib.request.urlopen(f"{url}/layer/slide/default/zoomify/TileGroup0/0-0-0.jpg", timeout=5) as resp:
        assert resp.headers["Content-Type"] == "image/jpeg"
    req = urllib.request.Request(f"{url}/shutdown", data=b"", method="PUT")
    with urllib.request.urlopen(req, timeout=5) as resp:
        assert json.loads(resp.read())["servers"] == 1
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert f"Serving on http://127.0.0.1:{port}" in capsys.readouterr().out


def test_module_entry_runs() -> None:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "tiatoolbox_tpu_torch.cli", "version"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120, check=True,
    )
    assert out.stdout.strip() == "tiatoolbox-tpu-torch 0.1.0"
