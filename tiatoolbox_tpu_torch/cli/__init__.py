"""Command line interface (counterpart of ``tiatoolbox_tpu/cli/__init__.py``).

JAX's 15 commands (:81-497) with the same option names, defaults, ``nargs``
and choices, on ``argparse`` (``cli/common.py`` says how click's semantics
are kept). Run ``python -m tiatoolbox_tpu_torch.cli <command>``, the
``tiatoolbox-tpu-torch`` script, or ``main([...])`` in-process. The
engine commands run on ``--device`` (``cuda`` unless ``--device cpu`` is
given); ``show-wsi`` and ``visualize`` serve the port's ``TileServer``.
"""

from __future__ import annotations

import json
from pathlib import Path

from tiatoolbox_tpu_torch import __version__
from tiatoolbox_tpu_torch.cli.common import (
    TIAToolboxCLI,
    _option,
    cli_auto_get_mask,
    cli_batch_size,
    cli_class_dict,
    cli_device,
    cli_file_type,
    cli_img_input,
    cli_input_resolutions,
    cli_masks,
    cli_memory_threshold,
    cli_min_distance,
    cli_mode,
    cli_num_workers,
    cli_output_file,
    cli_output_path,
    cli_output_resolutions,
    cli_output_type,
    cli_overwrite,
    cli_patch_input_shape,
    cli_patch_output_shape,
    cli_postproc_tile_shape,
    cli_pretrained_model,
    cli_pretrained_weights,
    cli_resolution,
    cli_return_predictions,
    cli_return_probabilities,
    cli_scale_factor,
    cli_stride_shape,
    cli_threshold_abs,
    cli_threshold_rel,
    cli_units,
    cli_verbose,
    cli_yaml_config_path,
    load_yaml_ioconfig,
    prepare_file_dir_cli,
)

# the engine commands' shared options (JAX ``cli/__init__.py:54-79``)
ENGINE_OPTIONS = (
    cli_device(),
    cli_num_workers(),
    cli_memory_threshold(),
    cli_patch_input_shape(),
    cli_stride_shape(),
    cli_patch_output_shape(),
    cli_input_resolutions(),
    cli_output_resolutions(),
    cli_return_probabilities(),
    cli_return_predictions(),
    cli_class_dict(),
    cli_scale_factor(),
    cli_overwrite(),
    cli_output_file(),
    cli_auto_get_mask(default=True),
    cli_yaml_config_path(),
)


def slide_info(img_input, output_path, file_types, mode, verbose) -> None:  # noqa: ARG001
    """Show or save normalized metadata of slide(s)."""
    from tiatoolbox_tpu_torch.utils.misc import save_yaml
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    files_all, output_path = prepare_file_dir_cli(img_input, output_path, file_types, mode, "meta-data")
    for file_path in files_all:
        wsi = WSIReader.open(file_path)
        info = wsi.info.as_dict()
        info = {k: (str(v) if isinstance(v, Path) else v) for k, v in info.items()}
        if mode == "show":
            print(json.dumps({k: str(v) for k, v in info.items()}, indent=2))
        else:
            save_yaml(
                {k: str(v) for k, v in info.items()},
                output_path / f"{Path(file_path).stem}.yaml",
                exist_ok=True,
            )
    print(f"Processed {len(files_all)} file(s).")


def slide_thumbnail(img_input, output_path, file_types, mode) -> None:
    """Save a low-resolution slide thumbnail."""
    from tiatoolbox_tpu_torch.utils.misc import imwrite
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    files_all, output_path = prepare_file_dir_cli(img_input, output_path, file_types, mode, "slide-thumbnail")
    for file_path in files_all:
        wsi = WSIReader.open(file_path)
        imwrite(output_path / f"{Path(file_path).stem}_thumb.png", wsi.slide_thumbnail())
    print(f"Saved {len(files_all)} thumbnail(s) to {output_path}.")


def read_bounds(img_input, output_path, resolution, units, region) -> None:
    """Read and save a bounds region from a slide."""
    from tiatoolbox_tpu_torch.utils.misc import imwrite
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    bounds = [int(v) for v in region.split(",")] if region else [0, 0, 2000, 2000]
    wsi = WSIReader.open(img_input)
    img = wsi.read_bounds(bounds, resolution=resolution, units=units)
    if output_path is None:
        output_path = Path(img_input).parent / "im_region.jpg"
    output_path = Path(output_path)
    if output_path.suffix.lower() not in (".jpg", ".jpeg", ".png", ".tiff", ".tif"):
        output_path = output_path / "im_region.jpg" if output_path.is_dir() else output_path.with_suffix(".jpg")
    imwrite(output_path, img)
    print(f"Saved region to {output_path}.")


def save_tiles(img_input, output_path, file_types, tile_objective_value, tile_read_size) -> None:
    """Save slide tiles at an objective power to a directory."""
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    files_all, output_path = prepare_file_dir_cli(img_input, output_path, file_types, "save", "tiles")
    for file_path in files_all:
        wsi = WSIReader.open(file_path)
        wsi.save_tiles(output_path, tile_objective_value, tile_read_size)
    print(f"Tiled {len(files_all)} slide(s) to {output_path}.")


def tissue_mask(img_input, output_path, file_types, method, resolution, units, mode, kernel_size) -> None:
    """Generate tissue masks for slide(s)."""
    import numpy as np

    from tiatoolbox_tpu_torch.utils.misc import imwrite
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    files_all, output_path = prepare_file_dir_cli(img_input, output_path, file_types, mode, "tissue-mask")
    masker_kwargs = {}
    if kernel_size:
        masker_kwargs["kernel_size"] = kernel_size
    for file_path in files_all:
        wsi = WSIReader.open(file_path)
        mask = wsi.tissue_mask(method=method.lower(), resolution=resolution, units=units)
        imwrite(output_path / f"{Path(file_path).stem}_mask.png", (mask.img.astype(np.uint8)) * 255)
    print(f"Masked {len(files_all)} slide(s).")


def stain_norm(img_input, target_input, output_path, file_types, method, stain_matrix) -> None:
    """Stain-normalize source image(s) to a target image."""
    from tiatoolbox_tpu_torch.data import stain_norm_target
    from tiatoolbox_tpu_torch.tools.stainnorm import get_normalizer
    from tiatoolbox_tpu_torch.utils.misc import imread, imwrite

    files_all, output_path = prepare_file_dir_cli(img_input, output_path, file_types, "save", "stainnorm_output")
    norm = get_normalizer(method, stain_matrix)
    target = imread(target_input) if target_input else stain_norm_target()
    norm.fit(target)
    for file_path in files_all:
        out = norm.transform(imread(file_path))
        imwrite(output_path / f"{Path(file_path).stem}_normalized.png", out)
    print(f"Normalized {len(files_all)} image(s) to {output_path}.")


def _engine_ioconfig(engine, mode, engine_kwargs: dict):
    """IO config precedence: yaml file > explicit resolution/shape flags > registry
    ioconfig (in baseline units for "tile" mode, where plain images carry no mpp)."""
    from tiatoolbox_tpu_torch.models.engine.io_config import IOSegmentorConfig, ModelIOConfigABC

    yaml_config_path = engine_kwargs.pop("yaml_config_path", None)
    input_resolutions = engine_kwargs.pop("input_resolutions", None)
    output_resolutions = engine_kwargs.pop("output_resolutions", None)
    patch_input_shape = engine_kwargs.pop("patch_input_shape", None) or None
    stride_shape = engine_kwargs.pop("stride_shape", None) or None
    patch_output_shape = engine_kwargs.pop("patch_output_shape", None) or None
    if yaml_config_path:
        return load_yaml_ioconfig(yaml_config_path)
    if input_resolutions or patch_input_shape or stride_shape or patch_output_shape or output_resolutions:
        base = engine.ioconfig
        io_kwargs = {
            "input_resolutions": input_resolutions
            or (base.input_resolutions if base else None)
            or [{"units": "baseline", "resolution": 1.0}],
            "patch_input_shape": patch_input_shape or (base.patch_input_shape if base else None),
            "stride_shape": stride_shape or (base.stride_shape if base else None),
            "output_resolutions": output_resolutions or (base.output_resolutions if base else []),
        }
        if patch_output_shape or (base is not None and getattr(base, "patch_output_shape", None)):
            io_kwargs["patch_output_shape"] = patch_output_shape or tuple(base.patch_output_shape)
            return IOSegmentorConfig(**io_kwargs)
        return ModelIOConfigABC(**io_kwargs)
    if mode == "tile" and engine.ioconfig is not None:
        return engine.ioconfig.to_baseline()
    return None


def _run_engine_cli(
    engine_cls,
    img_input,
    output_path,
    file_types,
    mode,
    pretrained_model,
    pretrained_weights,
    masks,
    batch_size,
    output_type,
    *,
    verbose: bool,
    **engine_kwargs,
):
    """Build ``engine_cls`` on ``--device`` and run it over the files (JAX ``cli/__init__.py:232-329``)."""
    files_all, output_path = prepare_file_dir_cli(img_input, output_path, file_types, mode, "engine_output")
    num_workers = engine_kwargs.pop("num_workers", None)
    overwrite = engine_kwargs.pop("overwrite", True)
    engine_init_kwargs = {"device": engine_kwargs["device"]}
    if num_workers is not None:
        engine_init_kwargs["num_loader_workers"] = num_workers
    engine = engine_cls(
        pretrained_model,
        weights=pretrained_weights,
        batch_size=batch_size,
        verbose=verbose,
        **engine_init_kwargs,
    )
    masks_list = [masks] * len(files_all) if masks else None
    ioconfig = _engine_ioconfig(engine, mode, engine_kwargs)
    # only the run params this engine takes; None values stay unset
    run_params = {k: v for k, v in engine_kwargs.items() if v is not None and k in engine_cls._RUN_PARAMS}
    out = engine.run(
        [str(f) for f in files_all],
        masks=masks_list,
        ioconfig=ioconfig,
        patch_mode=False,
        output_type=output_type,
        save_dir=output_path / "raw",
        overwrite=overwrite,
        **run_params,
    )
    print(json.dumps({str(k): str(v) for k, v in out.items()}, indent=2))
    return out


def _engine_command(module: str, class_name: str, doc: str):
    def run(**kwargs) -> None:
        import importlib

        engine_cls = getattr(importlib.import_module(f"tiatoolbox_tpu_torch.models.engine.{module}"), class_name)
        _run_engine_cli(engine_cls, **kwargs)

    run.__doc__ = doc
    return run


patch_predictor = _engine_command("patch_predictor", "PatchPredictor", "Patch-level classification over slide(s).")
semantic_segmentor = _engine_command("semantic_segmentor", "SemanticSegmentor", "Semantic segmentation over slide(s).")
multitask_segmentor = _engine_command(
    "multi_task_segmentor", "MultiTaskSegmentor", "Multi-task (instance) segmentation over slide(s)."
)
nucleus_instance_segment = _engine_command(
    "multi_task_segmentor", "NucleusInstanceSegmentor", "Nucleus instance segmentation (deprecated alias engine)."
)
nucleus_detector = _engine_command("nucleus_detector", "NucleusDetector", "Nucleus detection over slide(s).")
deep_feature_extractor = _engine_command(
    "deep_feature_extractor", "DeepFeatureExtractor", "Deep feature extraction over slide(s)."
)


def show_wsi(img_input, overlays, port, host) -> None:
    """Serve a slide (and overlays) through the tile server."""
    from tiatoolbox_tpu_torch.visualization.tileserver import TileServer

    layers = {"slide": img_input}
    if overlays:
        for i, overlay in enumerate(overlays.split(",")):
            layers[f"overlay-{i}"] = overlay.strip()
    server = TileServer(title="tiatoolbox-tpu-torch", layers=layers)
    print(f"Serving on http://{host}:{port}", flush=True)
    server.run(host=host, port=port)


def visualize(img_input, port) -> None:
    """Launch the visualization UI (tile server based)."""
    from tiatoolbox_tpu_torch.visualization.tileserver import TileServer

    layers = {"slide": img_input} if img_input else {}
    server = TileServer(title="tiatoolbox-tpu-torch", layers=layers)
    print(f"Serving on http://127.0.0.1:{port}", flush=True)
    server.run(host="127.0.0.1", port=port)


def version() -> None:
    """Show version."""
    print(f"tiatoolbox-tpu-torch {__version__}")


def _engine_options(default_model: str | None, output_type: str, extra=()) -> tuple:
    model = cli_pretrained_model() if default_model is None else cli_pretrained_model(default=default_model)
    return (
        cli_img_input(),
        cli_output_path(),
        cli_file_type(),
        cli_mode(),
        model,
        cli_pretrained_weights(),
        cli_masks(),
        cli_batch_size(),
        cli_output_type(default=output_type),
        cli_verbose(),
        *ENGINE_OPTIONS,
        *extra,
    )


def build_parser() -> TIAToolboxCLI:
    """The root parser with JAX's 15 commands."""
    cli = TIAToolboxCLI()
    show_save = ["show", "save"]
    cli.command(
        "slide-info",
        "Show or save normalized metadata of slide(s).",
        (
            cli_img_input(),
            cli_output_path(default=None),
            cli_file_type(),
            _option("--mode", default="show", choices=show_save),
            cli_verbose(),
        ),
        slide_info,
    )
    cli.command(
        "slide-thumbnail",
        "Save a low-resolution slide thumbnail.",
        (cli_img_input(), cli_output_path(), cli_file_type(), _option("--mode", default="save", choices=show_save)),
        slide_thumbnail,
    )
    cli.command(
        "read-bounds",
        "Read and save a bounds region from a slide.",
        (
            cli_img_input(),
            cli_output_path(),
            cli_resolution(),
            cli_units(),
            _option("--region", default=None, help="left,top,right,bottom", type=str),
        ),
        read_bounds,
    )
    cli.command(
        "save-tiles",
        "Save slide tiles at an objective power to a directory.",
        (
            cli_img_input(),
            cli_output_path(default="tiles"),
            cli_file_type(),
            _option("--tile-objective-value", default=20, type=int),
            _option("--tile-read-size", default=(5000, 5000), type=int, nargs=2),
        ),
        save_tiles,
    )
    cli.command(
        "tissue-mask",
        "Generate tissue masks for slide(s).",
        (
            cli_img_input(),
            cli_output_path(),
            cli_file_type(),
            _option("--method", default="Otsu", choices=["Otsu", "Morphological"]),
            cli_resolution(default=1.25),
            cli_units(default="power"),
            _option("--mode", default="save", choices=show_save),
            _option("--kernel-size", default=None, type=int, nargs=2),
        ),
        tissue_mask,
    )
    cli.command(
        "stain-norm",
        "Stain-normalize source image(s) to a target image.",
        (
            cli_img_input("Path to source image/patch."),
            _option("--target-input", help="Path to target (reference) image.", default=None),
            cli_output_path(default="stainnorm_output"),
            cli_file_type(default="*.png, *.jpg, *.tif, *.tiff"),
            _option("--method", default="reinhard", choices=["reinhard", "custom", "ruifrok", "macenko", "vahadane"]),
            _option("--stain-matrix", default=None, help="Stain matrix file for custom."),
        ),
        stain_norm,
    )
    engines = (
        ("patch-predictor", None, "zarr", patch_predictor, ()),
        ("semantic-segmentor", "fcn-tissue_mask", "zarr", semantic_segmentor, ()),
        ("multitask-segmentor", "hovernet_fast-pannuke", "annotationstore", multitask_segmentor, ()),
        ("nucleus-instance-segment", "hovernet_fast-pannuke", "annotationstore", nucleus_instance_segment, ()),
        ("nucleus-detector", "mapde-conic", "annotationstore", nucleus_detector,
         (cli_min_distance(), cli_threshold_abs(), cli_threshold_rel(), cli_postproc_tile_shape())),
        ("deep-feature-extractor", "resnet50-kather100k", "zarr", deep_feature_extractor, ()),
    )
    for name, model, output_type, handler, extra in engines:
        cli.command(name, handler.__doc__, _engine_options(model, output_type, extra), handler)
    cli.command(
        "show-wsi",
        "Serve a slide (and overlays) through the tile server.",
        (
            cli_img_input(),
            _option("--overlays", default=None, help="Comma-separated overlay paths."),
            _option("--port", default=5000, type=int),
            _option("--host", default="127.0.0.1"),
        ),
        show_wsi,
    )
    cli.command(
        "visualize",
        "Launch the visualization UI (tile server based).",
        (_option("--img-input", default=None), _option("--port", default=5006, type=int)),
        visualize,
    )
    cli.command("version", "Show version.", (), version)
    return cli


def main(argv: list[str] | None = None) -> int:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run the command; a usage error exits with 2."""
    cli = build_parser()
    args = cli.parse_args(argv)
    if args.command is None:
        cli.print_help()
        return 0
    values = dict(vars(args))
    command = values.pop("command")
    sub = cli.commands.choices[command]
    # click gives tuples for nargs=2 options
    for action in sub._actions:  # noqa: SLF001
        if action.nargs == 2 and isinstance(values.get(action.dest), list):
            values[action.dest] = tuple(values[action.dest])
    cli.handlers[command](**values)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
