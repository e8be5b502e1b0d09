"""Writes the JPEG fixtures of the port's decoder: ``tests/data/jpeg/``.

Not a test module.  Run from the repository root, where Pillow and the JAX
package's native decode pool (libjpeg-turbo) are built::

    JAX_PLATFORMS=cpu python tests/torch_jpeg_fixtures.py

Each fixture is made with Pillow from a seeded smooth image (sines and a
little noise, so it compresses like a photo).  ``digests.json`` holds, for
each, its parameters, its decoded shape and the sha256 of the JAX native
pool's decode (``deepfake_detection_tpu/data/native.py``, libjpeg-turbo
with ISLOW and fancy upsampling), or ``"declined"`` where that pool
returns None.  It also holds two sweeps, over one baseline and one
progressive fixture: truncations and bit flips, each with the first 16
hex digits of the sha256 of the port's decode where the script runs, or
None where the port declines (the tests hold the port against the JAX
pool on every case; ``chip_smoke.py`` replays the sweeps on the card's
host).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "jpeg")

#: name -> (height, width, seed, gray, Pillow save kwargs, extra)
FIXTURES = {
    **{f"face{i}": (640, 640, 10 + i, False,
                    dict(quality=90, subsampling=2), None) for i in range(4)},
    **{f"stream{i}": (480, 640, 20 + i, False,
                      dict(quality=85, subsampling=2), None)
       for i in range(2)},
    "s444_q95": (120, 160, 30, False, dict(quality=95, subsampling=0), None),
    "s422_q75": (120, 160, 31, False, dict(quality=75, subsampling=1), None),
    "gray": (120, 160, 32, True, dict(quality=90), None),
    # Pillow writes no 4:4:0: a 4:2:2 file of the transposed image with Y's
    # sampling factors and the frame's width and height swapped
    "s440": (120, 160, 33, False, dict(quality=85, subsampling=1), "440"),
    "prog420": (120, 160, 34, False,
                dict(quality=85, subsampling=2, progressive=True), None),
    "prog444_opt": (120, 160, 35, False,
                    dict(quality=85, subsampling=0, progressive=True,
                         optimize=True), None),
    "restart": (120, 160, 36, False,
                dict(quality=90, subsampling=2, restart_marker_blocks=3),
                None),
    "q100": (120, 160, 37, False, dict(quality=100, subsampling=2), None),
    "adobe_rgb": (120, 160, 38, False, dict(quality=90, keep_rgb=True),
                  None),
    "odd601x479": (479, 601, 39, False, dict(quality=90, subsampling=2),
                   None),
    "tiny17x9": (9, 17, 40, False, dict(quality=90, subsampling=2), None),
    "one1x1": (1, 1, 41, False, dict(quality=90, subsampling=2), None),
    "cmyk": (120, 160, 42, False, dict(quality=90), "cmyk"),
}

#: fixtures the sweeps corrupt: one baseline, one progressive
SWEEPS = ("s422_q75", "prog420")


def smooth_image(h: int, w: int, seed: int, gray: bool = False
                 ) -> np.ndarray:
    """A seeded smooth uint8 image, (h, w) or (h, w, 3)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w, 1)
    chans = []
    for _ in range(1 if gray else 3):
        a = g.uniform(0.5, 4, 3)
        ph = g.uniform(0, 6.3, 3)
        v = (128 + 60 * np.sin(a[0] * 6 * xx + ph[0])
             * np.cos(a[1] * 6 * yy + ph[1])
             + 40 * np.sin(a[2] * 9 * (xx + yy) + ph[2]))
        v += g.normal(0, 4, (h, w))
        chans.append(np.clip(v, 0, 255).astype(np.uint8))
    return chans[0] if gray else np.stack(chans, -1)


def encode(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def segment(data: bytes, marker: int) -> int:
    """Offset of the first marker segment ``marker`` before the scan."""
    i = 2
    while i + 4 <= len(data):
        if data[i + 1] == marker:
            return i
        i += 2 + (data[i + 2] << 8 | data[i + 3])
    raise ValueError(f"no marker {marker:#x}")


def to_440(data: bytes) -> bytes:
    """A 4:2:2 JPEG (Y 2x1) of an image as 4:4:0 (Y 1x2) of its transpose:
    the MCU count is unchanged, so the stream stays valid."""
    b = bytearray(data)
    i = segment(b, 0xC0)
    b[i + 5:i + 7], b[i + 7:i + 9] = b[i + 7:i + 9], b[i + 5:i + 7]
    assert b[i + 11] == 0x21
    b[i + 11] = 0x12
    return bytes(b)


def make(name: str) -> bytes:
    from PIL import Image
    h, w, seed, gray, kw, extra = FIXTURES[name]
    if extra == "440":
        arr = smooth_image(w, h, seed)            # transposed: the file
        return to_440(encode(arr, **kw))         # decodes to (h, w)
    arr = smooth_image(h, w, seed, gray)
    if extra == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG", **kw)
        return buf.getvalue()
    return encode(arr, **kw)


def sweep_cases(data: bytes, seed: int = 0):
    """``[(case, bytes)]``: truncations at 60 lengths and 400 bit flips
    (240 seeded bits of the headers up to the first scan's data, one
    seeded bit of 160 seeded data bytes); ``case`` is ``["trunc", n]`` or
    ``["flip", pos, bit]``."""
    g = np.random.default_rng(seed)
    header = segment(data, 0xDA) + 14
    cases = [(["trunc", int(n)], data[:int(n)])
             for n in np.linspace(0, len(data) - 1, 60).astype(int)]
    flips = sorted((int(k) // 8, int(k) % 8) for k in
                   g.choice(header * 8, 240, replace=False))
    flips += [(int(p), int(g.integers(8))) for p in
              sorted(g.choice(np.arange(header, len(data)), 160,
                              replace=False))]
    for p, b in flips:
        bb = bytearray(data)
        bb[p] ^= 1 << b
        cases.append((["flip", p, b], bytes(bb)))
    return cases


def apply_case(data: bytes, case) -> bytes:
    """The bytes of one committed sweep case."""
    if case[0] == "trunc":
        return data[:case[1]]
    bb = bytearray(data)
    bb[case[1]] ^= 1 << case[2]
    return bytes(bb)


def sha(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _dumps(digests: dict) -> str:
    """JSON with one fixture and one sweep case a line."""
    def block(items, inner):
        return "{\n" + ",\n".join(f" {json.dumps(k)}: {inner(v)}"
                                   for k, v in items) + "\n }"
    fixtures = block(sorted(digests["fixtures"].items()),
                     lambda v: json.dumps(v, sort_keys=True))
    sweeps = block(sorted(digests["sweeps"].items()),
                   lambda rows: "[\n  " + ",\n  ".join(
                       json.dumps(r) for r in rows) + "]")
    return (f'{{"decoder": {json.dumps(digests["decoder"])},\n'
            f'"fixtures": {fixtures},\n"sweeps": {sweeps}}}')


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    from deepfake_detection_tpu.data import native as jax_native
    from deepfake_detection_tpu_torch.data import native as port_native
    assert jax_native.available(), "the JAX native pool must be built"
    os.makedirs(OUT, exist_ok=True)
    digests = {"decoder": "deepfake_detection_tpu/data/native.py "
                          "(libjpeg-turbo, JDCT_ISLOW, JCS_RGB, fancy "
                          "upsampling)",
               "fixtures": {}, "sweeps": {}}
    for name, (h, w, seed, gray, kw, extra) in FIXTURES.items():
        data = make(name)
        with open(os.path.join(OUT, f"{name}.jpg"), "wb") as f:
            f.write(data)
        arr = jax_native.decode_jpeg_bytes(data)
        digests["fixtures"][name] = {
            "params": {"height": h, "width": w, "seed": seed, "gray": gray,
                       "extra": extra, **kw},
            "bytes": len(data),
            "shape": None if arr is None else list(arr.shape),
            "sha256": "declined" if arr is None else sha(arr)}
    for name in SWEEPS:
        data = make(name)
        rows = []
        for case, bb in sweep_cases(data):
            got = port_native.decode_jpeg_bytes(bb)
            rows.append([case, None if got is None else sha(got)[:16]])
        digests["sweeps"][name] = rows
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        f.write(_dumps(digests) + "\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(FIXTURES)} fixtures, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
