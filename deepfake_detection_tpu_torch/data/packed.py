"""Packed dataset cache: decoded clips in fixed-stride shards, read by mmap.

A copy of ``deepfake_detection_tpu/data/packed.py``; the format is the
JAX package's, so either package reads a pack the other wrote.  A pack
directory holds ``shard-NNNNN.bin`` files of ``(H, W, 3·frames)`` uint8
samples (the channel-packed layout the passthrough emits) and an
``index.json`` with the shape, the per-shard sample counts and sha256, the
clip table (kind, root, name, frames, label) and a fingerprint of the
source lists and pack parameters.  :class:`PackedDataset` is a
:class:`~.dataset.DeepFakeClipDataset` whose clip source is the index and
the mmapped shards: no decode, and batches bit-identical to the frame
tree's when the frames are at the pack's resolution.

Failures are loud: :class:`PackedCacheStale` when the lists or the
requested parameters changed since packing, :class:`PackedShardCorrupt`
when a shard's size or checksum is off (naming the shard and its samples).

:func:`write_pack` reads frames through the dataset's frame source
(``.npy`` beside the frame, else the JPEG through the port's own decoder,
so a JPEG tree packs on the card with no Pillow) and resizes, when asked,
with the port's numpy copy of Pillow's bilinear filter (``params.py``).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import (DeepFakeClipDataset, clip_frame_paths, load_frames,
                      read_clip_list)
from .resample import resample_axis
from .transforms import PackedFrames

__all__ = ["PackedDataset", "PackedShardCorrupt", "PackedCacheStale",
           "PACK_INDEX", "PACK_PARTIAL", "canonical_clip_array",
           "clip_records", "load_index", "open_shard_array",
           "pack_fingerprint", "read_source_lists", "verify_pack",
           "write_pack"]

PACK_INDEX = "index.json"
PACK_PARTIAL = "index.partial.json"
PACK_VERSION = 1

_REQUIRED_KEYS = ("version", "frames_per_clip", "sample_hw", "interpolation",
                  "roots", "lists", "fingerprint", "shards", "clips")


class PackedShardCorrupt(RuntimeError):
    """A shard's bytes disagree with its index entry (size or sha256); the
    message names the shard file and its global sample range."""


class PackedCacheStale(RuntimeError):
    """The pack disagrees with the source lists or the requested pack
    parameters (resolution, frames a clip, roots): re-pack."""


def read_source_lists(roots: Sequence[str]) -> List[Dict[str, list]]:
    """Each root's lists as the index stores them: ``[{"real": [[name,
    num], ...], "fake": [...]}, ...]``, in list-file order."""
    out = []
    for ri, root in enumerate(roots):
        out.append({kind: [[name, int(num)] for name, num, _ in
                           read_clip_list(os.path.join(
                               root, f"{kind}_list.txt"), ri)]
                    for kind in ("real", "fake")})
    return out


def pack_fingerprint(lists: List[Dict[str, list]],
                     image_size: Optional[int], interpolation: str,
                     frames_per_clip: int) -> str:
    """sha256 of the source lists and the pack parameters."""
    payload = json.dumps(
        {"lists": lists, "image_size": image_size or None,
         "interpolation": interpolation, "frames_per_clip": frames_per_clip},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def canonical_clip_array(frames: Sequence[np.ndarray],
                         image_size: Optional[int],
                         interpolation: str = "bilinear") -> np.ndarray:
    """A clip's frames → one ``(H, W, 3·k)`` uint8 array, each frame
    resized to ``image_size``² unless it is that size already."""
    arrs = []
    for a in frames:
        if image_size and a.shape[:2] != (image_size, image_size):
            if interpolation != "bilinear":
                raise ValueError(f"packing with {interpolation!r} resampling "
                                 f"needs Pillow's filters; the port resizes "
                                 f"bilinear only")
            a = resample_axis(resample_axis(a, image_size, 1),
                              image_size, 0)
        arrs.append(a)
    return np.concatenate(arrs, axis=-1)


def _sample_stride(index: Dict[str, Any]) -> int:
    h, w = index["sample_hw"]
    return int(h) * int(w) * 3 * int(index["frames_per_clip"])


def _atomic_json(path: str, obj: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_index(pack_dir: str) -> Dict[str, Any]:
    """Read and check a pack index."""
    path = os.path.join(pack_dir, PACK_INDEX)
    if not os.path.isfile(path):
        if os.path.isfile(os.path.join(pack_dir, PACK_PARTIAL)):
            raise PackedCacheStale(
                f"{pack_dir}: pack is incomplete (only {PACK_PARTIAL} "
                f"present); run write_pack again to finish it")
        raise FileNotFoundError(f"{path}: no pack index (build one with "
                                f"data/packed.py write_pack)")
    try:
        with open(path) as f:
            index = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise PackedCacheStale(f"{path}: unreadable pack index ({e})")
    missing = [k for k in _REQUIRED_KEYS if k not in index]
    if missing or int(index.get("version", -1)) != PACK_VERSION:
        raise PackedCacheStale(
            f"{path}: pack index version/schema mismatch (version "
            f"{index.get('version')!r}, missing keys {missing}); re-pack")
    if sum(int(s["num_samples"]) for s in index["shards"]) != \
            len(index["clips"]):
        raise PackedCacheStale(
            f"{path}: shard sample counts disagree with the clip table")
    return index


def _shard_size_problems(pack_dir: str, index: Dict[str, Any],
                         checksums: bool = False) -> List[str]:
    """Each shard's size (and, with ``checksums``, sha256) against the
    index; a problem names the shard file and its sample range."""
    problems = []
    stride = _sample_stride(index)
    start = 0
    for sh in index["shards"]:
        path = os.path.join(pack_dir, sh["file"])
        n = int(sh["num_samples"])
        want = n * stride
        rng_txt = f"samples [{start}, {start + n})"
        try:
            got = os.path.getsize(path)
        except OSError:
            problems.append(f"{path}: shard file missing ({rng_txt})")
            start += n
            continue
        if got != want:
            problems.append(f"{path}: {got} bytes, expected {want} "
                            f"({rng_txt})")
        elif checksums:
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
            if h.hexdigest() != sh["sha256"]:
                problems.append(f"{path}: checksum mismatch ({rng_txt})")
        start += n
    return problems


def verify_pack(pack_dir: str, checksums: bool = True) -> List[str]:
    """Problems of a pack (index, shard sizes, checksums); empty = clean."""
    try:
        index = load_index(pack_dir)
    except (FileNotFoundError, PackedCacheStale) as e:
        return [str(e)]
    return _shard_size_problems(pack_dir, index, checksums=checksums)


def clip_records(index: Dict[str, Any]
                 ) -> Dict[Tuple[str, int, str], Tuple[int, int]]:
    """``(kind, root_index, name) → (shard_index, slot)``."""
    records: Dict[Tuple[str, int, str], Tuple[int, int]] = {}
    pos = 0
    for si, sh in enumerate(index["shards"]):
        for slot in range(int(sh["num_samples"])):
            kind, ri, name = index["clips"][pos][:3]
            records[(kind, int(ri), name)] = (si, slot)
            pos += 1
    return records


def open_shard_array(pack_dir: str, index: Dict[str, Any],
                     si: int) -> np.ndarray:
    """One shard mmapped as ``(n, H, W, 3·frames)`` uint8, its size checked
    again at mmap time."""
    sh = index["shards"][si]
    n_s = int(sh["num_samples"])
    want = n_s * _sample_stride(index)
    path = os.path.join(pack_dir, sh["file"])
    with open(path, "rb") as f:
        got = os.fstat(f.fileno()).st_size
        if got != want:
            raise PackedShardCorrupt(
                f"{path}: {got} bytes at mmap time, "
                f"expected {want} ({n_s} samples)")
        mm = mmap.mmap(f.fileno(), want, access=mmap.ACCESS_READ)
    h, w = (int(v) for v in index["sample_hw"])
    return np.frombuffer(mm, np.uint8, count=want).reshape(
        (n_s, h, w, 3 * int(index["frames_per_clip"])))


class PackedDataset(DeepFakeClipDataset):
    """:class:`DeepFakeClipDataset` over a pack directory.

    The split, balance, ``noise_fake`` and subsetting run on the lists the
    index recorded.  ``roots`` (the run's ``--data``), when given, are read
    again and must match those lists; ``image_size`` must match the pack's
    resolution; ``verify`` checks every shard's sha256 up front (sizes are
    always checked).  A sample is a :class:`PackedFrames` of views into the
    mmapped shard."""

    def __init__(self, pack_dir: str, roots=None,
                 frames_per_clip: Optional[int] = None,
                 transform=None, train_split: bool = False,
                 train_ratio: float = 0.0, is_training: bool = False,
                 label_balance: bool = False, noise_fake: bool = False,
                 split_seed: int = 0, frac: float = 1.0,
                 n: Optional[int] = None,
                 image_size: Optional[int] = None, verify: bool = False):
        self.pack_dir = os.fspath(pack_dir)
        self.index = load_index(self.pack_dir)
        k = int(self.index["frames_per_clip"])
        if frames_per_clip is not None and int(frames_per_clip) != k:
            raise PackedCacheStale(
                f"{self.pack_dir}: packed at {k} frames/clip, the run "
                f"requests {frames_per_clip}")
        hw = [int(v) for v in self.index["sample_hw"]]
        if image_size and [int(image_size)] * 2 != hw:
            raise PackedCacheStale(
                f"{self.pack_dir}: packed at {hw[1]}x{hw[0]}, the run "
                f"requests {image_size}")
        self._lists = self.index["lists"]
        if roots is not None:
            if isinstance(roots, str):
                roots = [r for r in roots.split(":") if r]
            roots = list(roots)
            if len(roots) != len(self._lists):
                raise PackedCacheStale(
                    f"{self.pack_dir}: packed from {len(self._lists)} "
                    f"root(s), the run passes {len(roots)}")
            if read_source_lists(roots) != self._lists:
                raise PackedCacheStale(
                    f"{self.pack_dir}: source list files under {roots} "
                    f"changed since the pack was built (fingerprint "
                    f"{self.index['fingerprint'][:12]}…); re-pack")
        self._sample_shape = (hw[0], hw[1], 3 * k)
        self._records = clip_records(self.index)
        problems = _shard_size_problems(self.pack_dir, self.index,
                                        checksums=verify)
        if problems:
            raise PackedShardCorrupt("; ".join(problems))
        self._mmaps: Dict[int, np.ndarray] = {}
        self._open_lock = threading.Lock()
        super().__init__(
            roots if roots is not None else list(self.index["roots"]),
            frames_per_clip=k, transform=transform, train_split=train_split,
            train_ratio=train_ratio, is_training=is_training,
            label_balance=label_balance, noise_fake=noise_fake,
            split_seed=split_seed, frac=frac, n=n)

    def _read_root_lists(self, root_index: int):
        ls = self._lists[root_index]
        return ([(name, int(num), root_index) for name, num in ls["real"]],
                [(name, int(num), root_index) for name, num in ls["fake"]])

    def _load_clip(self, kind: str, clip: Tuple[str, int, int]):
        name, _num, ri = clip
        rec = self._records.get((kind, int(ri), name))
        if rec is None:
            raise PackedCacheStale(
                f"{self.pack_dir}: clip {kind}/{name} (root {ri}) is not "
                f"in the pack index")
        si, slot = rec
        base = self._shard_arrays(si)[slot]
        k = self.frames_per_clip
        return PackedFrames([base[..., 3 * i:3 * i + 3] for i in range(k)],
                            base)

    def _shard_arrays(self, si: int) -> np.ndarray:
        arr = self._mmaps.get(si)
        if arr is None:
            with self._open_lock:
                arr = self._mmaps.get(si)
                if arr is None:
                    arr = open_shard_array(self.pack_dir, self.index, si)
                    self._mmaps[si] = arr
        return arr

    def __getstate__(self):
        # shm-ring workers unpickle the dataset in a spawned process: mmaps
        # and locks do not cross; each process opens its shards lazily
        d = dict(self.__dict__)
        d["_mmaps"] = {}
        d["_open_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._open_lock = threading.Lock()

    @property
    def packed_hw(self) -> Tuple[int, int]:
        """(H, W) of the stored frames."""
        return self._sample_shape[0], self._sample_shape[1]

    def sample_array(self, index: int,
                     epoch: Optional[int] = None) -> np.ndarray:
        """The ``(H, W, 3·frames)`` view of one sample (no transform)."""
        kind, clip, _ = self.sample_clip(index, epoch)
        return self._load_clip(kind, clip).base


def _wipe_pack(out_dir: str) -> None:
    for fn in os.listdir(out_dir):
        if fn in (PACK_INDEX, PACK_PARTIAL) or (
                fn.startswith("shard-") and
                (fn.endswith(".bin") or ".bin.tmp" in fn)):
            try:
                os.remove(os.path.join(out_dir, fn))
            except OSError:
                pass


def write_pack(roots, out_dir: str, image_size: int = 0,
               frames_per_clip: int = 4, interpolation: str = "bilinear",
               shard_size: int = 256, workers: int = 4, max_shards: int = 0,
               force: bool = False, log=None) -> Dict[str, Any]:
    """Decode and pack every listed clip once; resumable by shard.

    Clips go root by root, fakes before reals (the dataset's index
    order); frames are resized to ``image_size``² unless they are that size
    (``0`` keeps the source size, which must then be uniform).  Each shard
    is written, fsynced and renamed into place, then the partial index is
    rewritten, so a killed packer resumes at the first missing shard;
    ``index.json`` appears only when every clip is packed.  ``max_shards``
    stops after that many shards.  Returns the index (partial if
    stopped)."""
    from concurrent.futures import ThreadPoolExecutor

    if log is None:
        log = lambda *_: None                                    # noqa: E731
    shard_size = int(shard_size)
    if shard_size < 1:
        raise ValueError(f"shard_size must be >= 1, got {shard_size}")
    if isinstance(roots, str):
        roots = [r for r in roots.split(":") if r]
    roots = [os.fspath(r) for r in roots]
    lists = read_source_lists(roots)
    entries = []
    for ri in range(len(roots)):
        for kind in ("fake", "real"):
            entries += [(kind, ri, name, int(num))
                        for name, num in lists[ri][kind]]
    if not entries:
        raise ValueError(f"no clips listed under roots {roots}")
    image_size = int(image_size or 0)
    fp = pack_fingerprint(lists, image_size or None, interpolation,
                          frames_per_clip)
    os.makedirs(out_dir, exist_ok=True)
    idx_path = os.path.join(out_dir, PACK_INDEX)
    partial_path = os.path.join(out_dir, PACK_PARTIAL)

    if os.path.isfile(idx_path):
        try:
            existing = load_index(out_dir)
        except PackedCacheStale:
            existing = None
        if existing is not None and existing["fingerprint"] == fp \
                and not force:
            log(f"{out_dir}: pack is up to date "
                f"({len(existing['clips'])} clips); nothing to do")
            return existing
        if not force:
            raise PackedCacheStale(
                f"{out_dir} already holds a pack built from different "
                f"sources or parameters; pass force to rebuild")
        _wipe_pack(out_dir)

    state: Optional[Dict[str, Any]] = None
    if os.path.isfile(partial_path):
        try:
            with open(partial_path) as f:
                state = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError):
            state = None
        if state is not None and (state.get("fingerprint") != fp or force):
            if not force:
                raise PackedCacheStale(
                    f"{partial_path}: partial pack was built from different "
                    f"sources or parameters; pass force to restart")
            state = None
        if state is not None and state["shards"] and not state["sample_hw"]:
            if not force:
                raise PackedCacheStale(
                    f"{partial_path}: torn partial index; pass force to "
                    f"restart the pack")
            state = None
        if state is None:
            _wipe_pack(out_dir)
        else:
            problems = _shard_size_problems(out_dir, state)
            if problems:
                raise PackedShardCorrupt(
                    "; ".join(problems) + "; remove the pack dir (or pass "
                    "force) to rebuild")
            log(f"{out_dir}: resuming after "
                f"{sum(int(s['num_samples']) for s in state['shards'])}/"
                f"{len(entries)} packed clips")
    if state is None:
        state = {"version": PACK_VERSION, "frames_per_clip": frames_per_clip,
                 "image_size": image_size or None, "sample_hw": None,
                 "dtype": "uint8", "interpolation": interpolation,
                 "roots": roots, "lists": lists, "fingerprint": fp,
                 "shards": [], "clips": []}

    done = sum(int(s["num_samples"]) for s in state["shards"])

    def _decode(entry):
        kind, ri, name, num = entry
        frames = load_frames(clip_frame_paths(
            roots, kind, (name, num, ri), frames_per_clip))
        return canonical_clip_array(frames, image_size, interpolation)

    with ThreadPoolExecutor(max(1, int(workers))) as pool:
        si = len(state["shards"])
        while done < len(entries):
            if max_shards and si >= int(max_shards):
                log(f"{out_dir}: stopping after {si} shards (max_shards); "
                    f"{done}/{len(entries)} clips packed")
                break
            chunk = entries[done:done + int(shard_size)]
            arrs = list(pool.map(_decode, chunk))
            for e, a in zip(chunk, arrs):
                if state["sample_hw"] is None:
                    state["sample_hw"] = [int(a.shape[0]), int(a.shape[1])]
                want = tuple(state["sample_hw"]) + (3 * frames_per_clip,)
                if a.shape != want:
                    raise ValueError(
                        f"clip {e[0]}/{e[2]}: decoded shape {a.shape} != "
                        f"pack stride {want}; the sources are of mixed "
                        f"size: pack with a fixed image_size")
            fname = f"shard-{si:05d}.bin"
            tmp = os.path.join(out_dir, f"{fname}.tmp.{os.getpid()}")
            h = hashlib.sha256()
            with open(tmp, "wb") as f:
                for a in arrs:
                    b = np.ascontiguousarray(a).tobytes()
                    h.update(b)
                    f.write(b)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(out_dir, fname))
            state["shards"].append({"file": fname,
                                    "num_samples": len(chunk),
                                    "sha256": h.hexdigest()})
            state["clips"] += [[kind, ri, name, num,
                                0 if kind == "fake" else 1]
                               for kind, ri, name, num in chunk]
            _atomic_json(partial_path, state)
            done += len(chunk)
            si += 1
            log(f"{fname}: {done}/{len(entries)} clips "
                f"({done * _sample_stride(state) / 1e9:.2f} GB)")

    if done >= len(entries):
        state["complete"] = True
        _atomic_json(idx_path, state)
        try:
            os.remove(partial_path)
        except OSError:
            pass
        log(f"{out_dir}: pack complete: {done} clips, "
            f"{len(state['shards'])} shards, "
            f"{done * _sample_stride(state) / 1e9:.2f} GB, "
            f"fingerprint {fp[:12]}…")
    return state
