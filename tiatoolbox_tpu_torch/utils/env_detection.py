"""Runtime environment detection (counterpart of ``tiatoolbox_tpu/utils/env_detection.py``).

JAX asks which JAX platform is present (:16-50); the port asks CUDA:
``has_gpu`` is ``torch.cuda.is_available()``, ``device_count`` is
``torch.cuda.device_count()`` and ``has_tpu`` is always False. The
environment checks (:53-115), ``version_to_tuple`` (:113-126) and
``has_network`` (:134-145) are JAX's, copied.
"""

from __future__ import annotations

import os

import torch


def has_tpu() -> bool:
    """False: the port runs on CUDA cards and the CPU only."""
    return False


def has_gpu() -> bool:
    """True if torch sees at least one CUDA device."""
    return torch.cuda.is_available()


def device_count() -> int:
    """Number of CUDA devices visible to this process."""
    return torch.cuda.device_count()


def running_on_ci() -> bool:
    """True when running under a CI environment."""
    return any(os.environ.get(k) for k in ("CI", "GITHUB_ACTIONS", "GITLAB_CI"))


def is_interactive() -> bool:
    """True when running in an interactive (notebook/REPL) session."""
    try:
        get_ipython  # type: ignore[name-defined]  # noqa: B018
    except NameError:
        return False
    return True


def is_notebook() -> bool:
    """True inside a Jupyter notebook kernel."""
    try:
        shell = get_ipython().__class__.__name__  # type: ignore[name-defined]
    except NameError:
        return False
    return shell == "ZMQInteractiveShell"


def in_conda_env() -> bool:
    """True inside an activated conda environment."""
    return "CONDA_DEFAULT_ENV" in os.environ and "CONDA_PREFIX" in os.environ


def running_on_github() -> bool:
    """True on GitHub Actions."""
    return os.environ.get("GITHUB_ACTIONS") == "true"


def running_on_circleci() -> bool:
    """True on CircleCI."""
    return os.environ.get("CIRCLECI") == "true"


def running_on_travis() -> bool:
    """True on Travis CI."""
    return os.environ.get("TRAVIS") == "true"


def running_on_kaggle() -> bool:
    """True on a Kaggle kernel."""
    return os.environ.get("KAGGLE_KERNEL_RUN_TYPE") is not None


def running_on_colab() -> bool:
    """True on Google Colab."""
    return "COLAB_GPU" in os.environ or "COLAB_RELEASE_TAG" in os.environ


def colab_has_gpu() -> bool:
    """True on a Colab runtime with a GPU attached."""
    return bool(int(os.environ.get("COLAB_GPU", 0)))


def version_to_tuple(version: str) -> tuple[int, ...]:
    """Parse a dotted version string to an int tuple ("1.2.3" -> (1, 2, 3))."""
    parts = []
    for chunk in version.split("."):
        digits = ""
        for ch in chunk:
            if not ch.isdigit():
                break
            digits += ch
        if not digits:
            break
        parts.append(int(digits))
    return tuple(parts)


def has_network(hostname: str = "huggingface.co", timeout: float = 3.0) -> bool:
    """True when an outbound connection to ``hostname`` succeeds."""
    import socket

    try:
        conn = socket.create_connection((hostname, 443), timeout=timeout)
    except OSError:
        return False
    conn.close()
    return True
