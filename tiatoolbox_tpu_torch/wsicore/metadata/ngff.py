"""OME-NGFF v0.4 metadata schema (counterpart of ``tiatoolbox_tpu/wsicore/metadata/ngff.py:1-247``).

The dataclasses and ``Zattrs`` with its ``from_dict``/``to_dict`` codecs,
copied; ``Creator`` names the port and its ``__version__``. Spec:
https://ngff.openmicroscopy.org/0.4/
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

from tiatoolbox_tpu_torch import __version__ as _pkg_version

SpaceUnits = Literal[
    "angstrom", "attometer", "centimeter", "decimeter", "exameter",
    "femtometer", "foot", "gigameter", "hectometer", "inch", "kilometer",
    "megameter", "meter", "micrometer", "mile", "millimeter", "nanometer",
    "parsec", "petameter", "picometer", "terameter", "yard", "yoctometer",
    "yottameter", "zeptometer", "zettameter",
]
TimeUnits = Literal[
    "attosecond", "centisecond", "day", "decisecond", "exasecond",
    "femtosecond", "gigasecond", "hectosecond", "hour", "kilosecond",
    "megasecond", "microsecond", "millisecond", "minute", "nanosecond",
    "petasecond", "picosecond", "second", "terasecond", "yoctosecond",
    "yottasecond", "zeptosecond", "zettasecond",
]
TCZYX = Literal["t", "c", "z", "y", "x"]


def _to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {k: _to_dict(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


@dataclass
class Creator:
    """Writer identification (``_creator`` in .zattrs)."""

    name: str = "tiatoolbox_tpu_torch"
    version: str = _pkg_version


@dataclass
class CoordinateTransform:
    """Zarr → slide coordinate transform ("identity" or "scale")."""

    type: str = "identity"
    scale: list[float] | None = None


@dataclass
class Dataset:
    """One resolution level: path + its coordinate transforms."""

    path: str = "0"
    coordinateTransformations: list[CoordinateTransform] = field(  # noqa: N815
        default_factory=lambda: [CoordinateTransform()],
    )


@dataclass
class Axis:
    """Axis name/type/unit ("y"/"x" space axes carry length units)."""

    name: TCZYX
    type: Literal["time", "space", "channel"]
    unit: SpaceUnits | TimeUnits | None = None


@dataclass
class Multiscales:
    """The multiscales entry: axes + per-level datasets."""

    axes: list[Axis] = field(
        default_factory=lambda: [
            Axis("y", "space", "micrometer"),
            Axis("x", "space", "micrometer"),
            Axis("c", "channel", None),
        ],
    )
    datasets: list[Dataset] = field(default_factory=lambda: [Dataset()])
    version: str = "0.4"

    def __iter__(self):
        yield from self.__dict__.values()


@dataclass
class Window:
    """Display range of a channel."""

    end: int = 255
    max: int = 255
    min: int = 0
    start: int = 0


@dataclass
class Channel:
    """Display description of one channel."""

    active: bool = True
    coefficient: float = 1.0
    color: str = "FF0000"
    family: str = "linear"
    inverted: bool = False
    label: str = "Red"
    window: Window = field(default_factory=Window)


@dataclass
class RDefs:
    """Default time point / z-plane / colour model."""

    defaultT: int = 0  # noqa: N815
    defaultZ: int = 0  # noqa: N815
    model: Literal["color", "greyscale"] = "color"


@dataclass
class Omero:
    """omero display block (channel colors etc.)."""

    name: str | None = None
    id: int = 1
    channels: list = field(
        default_factory=lambda: [
            Channel(label="Red", color="FF0000"),
            Channel(label="Green", color="00FF00"),
            Channel(label="Blue", color="0000FF"),
        ],
    )
    rdefs: RDefs = field(default_factory=RDefs)
    version: str = "0.4"


@dataclass
class Zattrs:
    """Root .zattrs document."""

    _creator: Creator = field(default_factory=Creator)
    multiscales: Multiscales | list[Multiscales] = field(
        default_factory=lambda: [Multiscales()],
    )
    _ARRAY_DIMENSIONS: list[TCZYX] = field(default_factory=lambda: ["y", "x", "c"])
    omero: Omero = field(default_factory=Omero)

    def to_dict(self) -> dict:
        """Plain-dict form, writable as .zattrs JSON."""
        return _to_dict(self)

    @classmethod
    def from_dict(cls, attrs: dict) -> "Zattrs":
        """Parse a .zattrs mapping into typed objects (tolerant of
        missing blocks — defaults fill in)."""
        creator_raw = attrs.get("_creator", {})
        creator = Creator(
            name=creator_raw.get("name", "unknown"),
            version=str(creator_raw.get("version", "")),
        )

        def _axis(a: dict) -> Axis:
            # tolerate spec-optional / vendor fields: "type" is a
            # SHOULD (pre-0.4 writers omit it) — infer from the name
            name = a.get("name", "x")
            default_type = {"c": "channel", "t": "time"}.get(name, "space")
            return Axis(
                name=name,
                type=a.get("type", default_type),
                unit=a.get("unit"),
            )

        ms_raw = attrs.get("multiscales", [{}])
        if isinstance(ms_raw, dict):
            ms_raw = [ms_raw]
        multiscales = [
            Multiscales(
                axes=[_axis(a) for a in m.get("axes", [])]
                or Multiscales().axes,
                datasets=[
                    Dataset(
                        path=d.get("path", "0"),
                        coordinateTransformations=[
                            CoordinateTransform(
                                type=t.get("type", "identity"),
                                scale=t.get("scale"),
                            )
                            for t in d.get("coordinateTransformations", [{}])
                        ],
                    )
                    for d in m.get("datasets", [])
                ]
                or [Dataset()],
                version=str(m.get("version", "0.4")),
            )
            for m in ms_raw
        ]
        omero_raw = attrs.get("omero", {})

        def _channel(c: dict) -> Channel:
            defaults = Channel()
            win = c.get("window")
            window = (
                Window(**{
                    k: win.get(k, getattr(Window(), k))
                    for k in ("end", "max", "min", "start")
                })
                if isinstance(win, dict)
                else Window()
            )
            return Channel(
                active=c.get("active", defaults.active),
                coefficient=c.get("coefficient", defaults.coefficient),
                color=c.get("color", defaults.color),
                family=c.get("family", defaults.family),
                inverted=c.get("inverted", defaults.inverted),
                label=c.get("label", defaults.label),
                window=window,
            )

        rdefs_raw = omero_raw.get("rdefs", {})
        omero = Omero(
            name=omero_raw.get("name"),
            id=omero_raw.get("id", 1),
            channels=[_channel(c) for c in omero_raw.get("channels", [])]
            or Omero().channels,
            rdefs=RDefs(
                defaultT=rdefs_raw.get("defaultT", 0),
                defaultZ=rdefs_raw.get("defaultZ", 0),
                model=rdefs_raw.get("model", "color"),
            ),
            version=str(omero_raw.get("version", "0.4")),
        )
        return cls(
            _creator=creator,
            multiscales=multiscales,
            _ARRAY_DIMENSIONS=attrs.get("_ARRAY_DIMENSIONS", ["y", "x", "c"]),
            omero=omero,
        )
