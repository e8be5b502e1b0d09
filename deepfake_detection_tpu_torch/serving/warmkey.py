"""Content-addressed keys and manifests of the warm-start store.

The counterpart of ``deepfake_detection_tpu/serving/warmkey.py``, with its
contracts (``KEY_FIELDS``, :func:`store_key`, :func:`encode_array` /
:func:`decode_array`, :func:`write_atomic`, :func:`write_manifest` /
:func:`read_manifest`) and its runtime fields made the card's.  Torch-free
on purpose: a key can be computed and audited without importing torch, so
the router side and offline tools can reason about a store's contents.
The store itself is ``serving/warmstart.py``.

A store key is the sha256 of the canonical JSON of a *complete*
fingerprint of everything an entry is a function of:

===================  =====================================================
field                meaning
===================  =====================================================
``schema``           ``dfd.torch.warmstart.v1``: bump to orphan a store
``torch``            the installed torch distribution's version
``cuda``             ``torch.version.cuda`` (``none`` on a CPU build)
``nvcc``             the ``release`` line of the nvcc ``build()`` calls
``driver``           the NVIDIA driver's version (``none`` without one)
``device_kind``      ``torch.cuda.get_device_name`` (``cpu`` on the CPU)
``capability``       the card's compute capability, ``"9.0"`` on an H100
``program``          a kernel library: ``csrc/build.py``'s digest of its
                     source, the ``*.cuh`` headers and the flags; a
                     capture: sha256 of the model's repr, the state_dict's
                     (name, shape, dtype), the normalization constants and
                     the kernel libraries' digests (weights are not in it)
``geometry``         image_size / img_num / model-class dict (a library:
                     its name)
``bucket``/``chans`` the padded batch bucket and input channel width
``wire``             wire dtype (``uint8`` / ``float32``)
``quant``            params quantization mode (``f32``/``bf16``/``int8``)
``sharding``         "" (the port serves on one card)
===================  =====================================================

Any field drift gives another key and so a clean miss; a foreign file
under the right name is still rejected by the manifest's echo of the
fields and, for a library, by the payload's sha256 and the kernel canary
(``csrc/build.py``), for a capture by the golden-batch canary.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from importlib import metadata, util
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

WARMSTART_SCHEMA = "dfd.torch.warmstart.v1"

#: key fields that must be present before hashing: a partial key is a bug,
#: not a miss, so ``store_key`` refuses to hash one
KEY_FIELDS = (
    "schema", "torch", "cuda", "nvcc", "driver", "device_kind", "capability",
    "program", "geometry", "bucket", "chans", "wire", "quant", "sharding",
)


def _torch_cuda() -> str:
    """``torch.version.cuda`` read from the installed ``torch/version.py``
    without importing torch."""
    spec = util.find_spec("torch")
    if spec is None or not spec.submodule_search_locations:
        return "none"
    path = Path(list(spec.submodule_search_locations)[0]) / "version.py"
    try:
        m = re.search(r"^cuda\s*(?::[^=]*)?=\s*(['\"]?)([^'\"\n]*)\1",
                      path.read_text(), re.M)
    except OSError:
        return "unknown"
    if m is None or m.group(2) in ("", "None"):
        return "none"
    return m.group(2)


def nvcc_path() -> Optional[str]:
    """The nvcc ``csrc/build.py`` calls (PATH, ``$CUDA_HOME/bin``,
    ``/usr/local/cuda/bin``), or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "nvcc"
    return str(cand) if cand.is_file() else None


def nvcc_version() -> str:
    """``nvcc --version`` in full ("" without an nvcc)."""
    path = nvcc_path()
    if path is None:
        return ""
    try:
        return subprocess.run([path, "--version"], capture_output=True,
                              text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def _nvcc_release(full: str) -> str:
    for line in full.splitlines():
        if "release" in line:
            return line.strip()
    return "none"


def _driver() -> str:
    """The NVIDIA kernel module's version, from ``/proc`` or
    ``nvidia-smi``; ``none`` without a driver."""
    try:
        text = Path("/proc/driver/nvidia/version").read_text()
        m = re.search(r"Kernel Module\s+([0-9.]+)", text)
        if m:
            return m.group(1)
    except OSError:
        pass
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "none"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


_versions: Optional[Dict[str, str]] = None


def runtime_versions() -> Dict[str, str]:
    """torch, cuda, nvcc and driver versions, read once a process without
    importing torch or creating a CUDA context."""
    global _versions
    if _versions is None:
        try:
            torch_v = metadata.version("torch")
        except metadata.PackageNotFoundError:      # pragma: no cover
            torch_v = "unknown"
        _versions = {"torch": torch_v, "cuda": _torch_cuda(),
                     "nvcc": _nvcc_release(nvcc_version()),
                     "driver": _driver()}
    return dict(_versions)


def key_fields(*, device_kind: str, capability: str, program: str,
               geometry: Dict[str, Any], bucket: int, chans: int,
               wire: str, quant: str, sharding: str = "") -> Dict[str, Any]:
    """Assemble the complete key-field dict (versions filled in here)."""
    vers = runtime_versions()
    return {
        "schema": WARMSTART_SCHEMA,
        "torch": vers["torch"],
        "cuda": vers["cuda"],
        "nvcc": vers["nvcc"],
        "driver": vers["driver"],
        "device_kind": str(device_kind),
        "capability": str(capability),
        "program": str(program),
        "geometry": dict(geometry),
        "bucket": int(bucket),
        "chans": int(chans),
        "wire": str(wire),
        "quant": str(quant),
        "sharding": str(sharding),
    }


def store_key(fields: Dict[str, Any]) -> str:
    """sha256 over the canonical JSON of a *complete* field dict."""
    missing = [f for f in KEY_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"incomplete warmstart key, missing {missing}")
    blob = json.dumps(fields, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def encode_array(arr: np.ndarray) -> Dict[str, Any]:
    """Bit-exact JSON-able encoding of an ndarray (golden scores)."""
    a = np.ascontiguousarray(arr)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(enc: Dict[str, Any]) -> np.ndarray:
    buf = base64.b64decode(enc["data"])
    return np.frombuffer(buf, dtype=np.dtype(enc["dtype"])).reshape(
        enc["shape"])


def write_atomic(path: str, blob: bytes) -> None:
    """write → fsync → atomic rename, so a crashed writer leaves the old
    file or the new one, never a part."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".warm-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    blob = (json.dumps(manifest, sort_keys=True) + "\n").encode()
    write_atomic(path, blob)


def read_manifest(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return json.loads(f.read().decode())
