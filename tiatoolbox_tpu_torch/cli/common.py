"""Shared CLI options and helpers (counterpart of ``tiatoolbox_tpu/cli/common.py``).

JAX builds its CLI on click (:1-305); the card machine has no click, so the
port's is written on ``argparse`` with the same option names, defaults,
``nargs`` and choices. Each ``cli_*`` function returns an option: a
callable that adds its argument to a sub-command's parser, as each of
JAX's returns a click decorator. Click's semantics kept here:

- an option left out is ``None`` unless it has a default;
- ``type=(int, int)`` and ``nargs=2`` options give tuples;
- ``type=bool`` options take click's spellings (``1``/``0``, ``true``/
  ``false``, ``yes``/``no``, ``on``/``off``, ``t``/``f``, ``y``/``n``, and
  the empty string as False);
- ``--verbose/--quiet`` is a pair of flags on one destination;
- the JSON options (:147, :180) parse their value and refuse bad JSON as a
  usage error;
- a usage error exits with code 2, as click's does.

``--device`` defaults to ``"cuda"`` (JAX's to ``"cpu"``) and takes
``cpu``, ``cuda`` and ``cuda:N``; anything else is a usage error.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path


def _option(*flags: str, **kwargs):
    """An option: a callable that adds ``flags`` to a parser with ``kwargs``."""

    def add(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser.add_argument(*flags, **kwargs)
        return parser

    return add


_BOOL_STATES = {
    "1": True, "0": False, "yes": True, "no": False, "true": True, "false": False, "on": True,
    "off": False, "t": True, "f": False, "y": True, "n": False, "": False,
}


def click_bool(value: str) -> bool:
    """click's ``BOOL`` conversion."""
    state = _BOOL_STATES.get(value.strip().lower())
    if state is None:
        msg = f"{value!r} is not a valid boolean. Recognized values: {', '.join(sorted(_BOOL_STATES))}"
        raise argparse.ArgumentTypeError(msg)
    return state


_DEVICE_RE = re.compile(r"^(cpu|cuda|cuda:\d+)$")


def device_name(value: str) -> str:
    """``cpu``, ``cuda`` or ``cuda:N``; anything else is a usage error."""
    if not _DEVICE_RE.match(value):
        msg = f"unknown device {value!r}: use cpu, cuda or cuda:N"
        raise argparse.ArgumentTypeError(msg)
    return value


def cli_img_input(usage_help: str = "Path to WSI or image file."):
    """Shared --img-input option."""
    return _option("--img-input", help=usage_help, type=str, default=None)


def cli_output_path(usage_help: str = "Path to output directory.", default=None):
    """Shared --output-path option."""
    return _option("--output-path", help=usage_help, default=default, type=str)


def cli_file_type(default: str = "*.svs, *.tiff, *.tif, *.png, *.jpg"):
    """Shared --file-types option."""
    return _option("--file-types", help="File types to process (comma separated).", default=default, type=str)


def cli_mode(default: str = "wsi"):
    """Shared --mode option."""
    return _option("--mode", help="'wsi' or 'tile' processing mode.", default=default, choices=["wsi", "tile"])


def cli_resolution(default: float = 0):
    """Shared --resolution option."""
    return _option("--resolution", default=default, type=float)


def cli_units(default: str = "level"):
    """Shared --units option."""
    return _option("--units", default=default, choices=["mpp", "power", "level", "baseline"])


def cli_batch_size(default: int = 16):
    """Shared --batch-size option."""
    return _option("--batch-size", default=default, type=int)


def cli_pretrained_model(default: str = "resnet18-kather100k"):
    """Shared --pretrained-model option."""
    return _option("--pretrained-model", default=default, help="Name of a model from the pretrained registry.")


def cli_pretrained_weights(default=None):
    """Shared --pretrained-weights option."""
    return _option("--pretrained-weights", default=default, help="Path to local model weights (.pth torch or .npz flax).")


def cli_masks(default=None):
    """Shared --masks option."""
    return _option("--masks", default=default, type=str)


def cli_output_type(default: str = "zarr"):
    """Shared --output-type option."""
    return _option("--output-type", default=default, choices=["dict", "zarr", "annotationstore", "qupath"])


def cli_verbose(default: bool = True):
    """Shared --verbose/--quiet flag pair."""

    def add(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser.add_argument("--verbose", dest="verbose", action="store_true", default=default)
        parser.add_argument("--quiet", dest="verbose", action="store_false")
        return parser

    return add


def cli_device(default: str = "cuda"):
    """Shared --device option: ``cpu``, ``cuda`` or ``cuda:N``."""
    return _option("--device", default=default, type=device_name, help="Inference device: cpu, cuda or cuda:N.")


def cli_num_workers(default=None):
    """Shared --num-workers option (host loader threads; None keeps the engine's default)."""
    return _option("--num-workers", default=default, type=int)


def cli_memory_threshold(default: int = 80):
    """Shared --memory-threshold option (RAM %% before zarr spill)."""
    return _option("--memory-threshold", default=default, type=int)


def cli_patch_input_shape(default=None):
    """Shared --patch-input-shape option (two ints)."""
    return _option("--patch-input-shape", type=int, nargs=2, default=default)


def cli_stride_shape(default=None):
    """Shared --stride-shape option (two ints)."""
    return _option("--stride-shape", type=int, nargs=2, default=default)


def cli_patch_output_shape(default=None):
    """Shared --patch-output-shape option (two ints)."""
    return _option("--patch-output-shape", type=int, nargs=2, default=default)


def _json_value(name: str):
    def parse(value: str):
        try:
            return json.loads(value)
        except json.JSONDecodeError as exc:
            msg = f"{name} must be valid JSON: {exc}"
            raise argparse.ArgumentTypeError(msg) from exc

    return parse


def cli_input_resolutions():
    """--input-resolutions as a JSON list.

    Example: ``--input-resolutions '[{"units": "mpp", "resolution": 0.25}]'``
    """
    return _option("--input-resolutions", default=None, type=_json_value("--input-resolutions"),
                   help="JSON list of {units, resolution} dicts.")


def cli_output_resolutions():
    """--output-resolutions as a JSON list."""
    return _option("--output-resolutions", default=None, type=_json_value("--output-resolutions"),
                   help="JSON list of {units, resolution} dicts.")


def _class_dict(value: str) -> dict:
    raw = _json_value("--class-dict")(value)
    out = {}
    for k, v in raw.items():
        try:
            out[int(k)] = v
        except (TypeError, ValueError):
            out[k] = v
    return out


def cli_class_dict():
    """--class-dict as a JSON mapping (int keys where possible)."""
    return _option("--class-dict", default=None, type=_class_dict,
                   help='Class-index to name mapping, e.g. \'{"0": "tumour"}\'.')


def cli_scale_factor(default=None):
    """Shared --scale-factor option (two floats)."""
    return _option("--scale-factor", type=float, nargs=2, default=default)


def cli_return_probabilities(*, default: bool = False):
    """Shared --return-probabilities option."""
    return _option("--return-probabilities", type=click_bool, default=default)


def cli_return_predictions(*, default: bool = False):
    """Shared --return-predictions option."""
    return _option("--return-predictions", type=click_bool, default=default)


def cli_auto_get_mask(*, default: bool = False):
    """Shared --auto-get-mask option."""
    return _option("--auto-get-mask", type=click_bool, default=default)


def cli_overwrite(*, default: bool = True):
    """Shared --overwrite option."""
    return _option("--overwrite", type=click_bool, default=default)


def cli_output_file(default=None):
    """Shared --output-file option (per-run output filename)."""
    return _option("--output-file", type=str, default=default)


def cli_yaml_config_path(default=None):
    """Shared --yaml-config-path option (IO config from yaml)."""
    return _option("--yaml-config-path", type=str, default=default)


def cli_min_distance(default=None):
    """Detector --min-distance peak separation."""
    return _option("--min-distance", type=int, default=default)


def cli_threshold_abs(default=None):
    """Detector --threshold-abs peak threshold."""
    return _option("--threshold-abs", type=float, default=default)


def cli_threshold_rel(default=None):
    """Detector --threshold-rel relative peak threshold."""
    return _option("--threshold-rel", type=float, default=default)


def cli_postproc_tile_shape(default=None):
    """Detector --postproc-tile-shape (two ints)."""
    return _option("--postproc-tile-shape", type=int, nargs=2, default=default)


def load_yaml_ioconfig(yaml_config_path):
    """Build an IO config from a yaml file (JAX ``cli/common.py:262-279``).

    Keys are the ModelIOConfigABC/IOSegmentorConfig kwargs; the class is
    chosen by the presence of segmentor-only keys. The file is read by the
    port's YAML reader (``utils/yaml_lite.py``).
    """
    from tiatoolbox_tpu_torch.models.engine.io_config import IOSegmentorConfig, ModelIOConfigABC
    from tiatoolbox_tpu_torch.utils import yaml_lite

    data = yaml_lite.load(Path(yaml_config_path).read_text())
    seg_keys = {"patch_output_shape", "save_resolution", "margin", "tile_shape"}
    cls = IOSegmentorConfig if seg_keys & set(data) else ModelIOConfigABC
    return cls(**data)


def prepare_file_dir_cli(img_input, output_path, file_types, mode, sub_dirname):
    """Resolve input files and output directory for batch commands."""
    from tiatoolbox_tpu_torch.utils import misc

    input_path = Path(img_input)
    if not input_path.exists():
        msg = f"Input path does not exist: {input_path}"
        raise FileNotFoundError(msg)
    files_all = (
        [input_path]
        if input_path.is_file()
        else misc.grab_files_from_dir(input_path, tuple(ft.strip() for ft in file_types.split(",")))
    )
    if output_path is None:
        output_path = input_path.parent / sub_dirname
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    del mode
    return files_all, output_path


class TIAToolboxCLI(argparse.ArgumentParser):
    """Root parser: one sub-command a command, as JAX's click group."""

    def __init__(self, prog: str = "tiatoolbox-tpu-torch") -> None:
        super().__init__(
            prog=prog,
            description="Computational pathology toolbox by TIA Centre, ported to PyTorch and CUDA.",
        )
        self.commands = self.add_subparsers(
            dest="command", metavar="COMMAND", parser_class=argparse.ArgumentParser
        )
        self.handlers: dict[str, callable] = {}

    def command(self, name: str, help_text: str, options, handler) -> argparse.ArgumentParser:
        """Add the sub-command ``name`` with ``options``; ``handler`` takes its values as keywords."""
        sub = self.commands.add_parser(name, help=help_text, description=help_text)
        for option in options:
            option(sub)
        self.handlers[name] = handler
        return sub
