"""Standalone-codec export, and the build and run of the C++ codec binary.

Counterpart of ``cra5_tpu/standalone/export.py``, with the same files:

  - ``write_tables_file`` / ``load_tables_file``: CDF tables as CRT1;
    ``write_tensor_file`` / ``read_tensor_file``: int32 (CRX1) and float32
    (CRXf) tensors.
  - ``export_synthesis`` / ``export_analysis``: a ``models/google.py``
    ``_ConvStack`` as the CRS1 (float) or CRSq (int16 weights) network
    file the C++ engine runs. Each stack is first laid out as its flax
    ``params`` subtree by ``convert.to_flax_params`` (the one mapping
    between the packages), then written by the JAX package's steps: conv
    kernels (kh, kw, cin, cout), deconv kernels flipped spatially, GDN's
    raw parameters resolved to their effective values. So the bytes equal
    the JAX package's for the same weights.
  - ``export_codec``: a codec's EB (and GC) tables, the quantizer JSON and
    the flat params ``.npz`` (flax paths); the tables are built first when
    the codec has none (``_require_tables``).
  - ``extract_cdf_from_latents``: per-channel CDFs from latent histograms.
  - ``build_codec_binary`` / ``run_codec``: the pure C++ encoder, decoder
    and RDOQ of ``csrc/cra5_codec.cpp`` (the JAX package's source, copied
    byte for byte), built by g++ into ``build/cra5_tpu_torch/`` at the root
    of the checkout, named by a digest of the source and flags, never next
    to the source. A failed build raises with g++'s output; nothing falls
    back.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
from torch import nn

from ..convert import to_flax_params
from ..entropy.cdf import CdfTable, build_cdf_table

_SRC = Path(__file__).resolve().parent / "csrc" / "cra5_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cra5_tpu_torch"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-pthread"]


def build_codec_binary() -> str:
    """Compile the standalone codec with g++ once per source content and
    return the binary's path. Raises when g++ is missing or fails."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"cra5_codec_{digest}"
    if out.exists():
        return str(out)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the standalone codec is built at first use with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")  # concurrent builds each rename theirs
    r = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return str(out)


def write_tables_file(path: str, table: CdfTable) -> None:
    with open(path, "wb") as f:
        f.write(b"CRT1")
        f.write(struct.pack("<ii", table.num_indexes, table.max_length))
        f.write(np.ascontiguousarray(table.quantized_cdf, np.int32).tobytes())
        f.write(np.ascontiguousarray(table.cdf_length, np.int32).tobytes())
        f.write(np.ascontiguousarray(table.offset, np.int32).tobytes())


def load_tables_file(path: str) -> CdfTable:
    with open(path, "rb") as f:
        if f.read(4) != b"CRT1":
            raise ValueError("bad tables file")
        n, stride = struct.unpack("<ii", f.read(8))
        cdf = np.frombuffer(f.read(4 * n * stride), np.int32).reshape(n, stride)
        length = np.frombuffer(f.read(4 * n), np.int32)
        offset = np.frombuffer(f.read(4 * n), np.int32)
    return CdfTable(quantized_cdf=cdf.copy(), cdf_length=length.copy(), offset=offset.copy())


def write_tensor_file(path: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        magic = b"CRXf"
    elif arr.dtype == np.int32:
        magic = b"CRX1"
    else:
        raise ValueError("tensor must be int32 or float32")
    with open(path, "wb") as f:
        f.write(magic)
        f.write(struct.pack("<i", arr.ndim))
        f.write(np.asarray(arr.shape, np.int32).tobytes())
        f.write(arr.tobytes())


def read_tensor_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic not in (b"CRX1", b"CRXf"):
            raise ValueError("bad tensor file")
        (ndim,) = struct.unpack("<i", f.read(4))
        dims = np.frombuffer(f.read(4 * ndim), np.int32)
        data = np.frombuffer(f.read(), np.float32 if magic == b"CRXf" else np.int32)
    return data.reshape(dims).copy()


def run_codec(*args: str) -> subprocess.CompletedProcess:
    """Run the standalone binary (built at first use) with ``args``;
    raises ``CalledProcessError`` on a non-zero exit."""
    return subprocess.run([build_codec_binary(), *args], check=True, capture_output=True,
                          text=True)


def extract_cdf_from_latents(latents: np.ndarray, tail_mass: float = 1e-6,
                             precision: int = 16) -> CdfTable:
    """Per-channel quantized CDFs from the histogram of the rounded
    latents, (N, C, H, W) or (C, ...); a tail mass stays reserved so unseen
    symbols remain codable through the escape."""
    if latents.ndim == 4:
        per_chan = latents.transpose(1, 0, 2, 3).reshape(latents.shape[1], -1)
    else:
        per_chan = latents.reshape(latents.shape[0], -1)
    C = per_chan.shape[0]
    sym = np.round(per_chan).astype(np.int64)
    mins = sym.min(axis=1)
    lengths = (sym.max(axis=1) - mins + 1).astype(np.int64)
    pmfs = np.zeros((C, int(lengths.max())), np.float64)
    for c in range(C):
        counts = np.bincount(sym[c] - mins[c], minlength=lengths[c]).astype(np.float64)
        pmfs[c, :lengths[c]] = counts / counts.sum() * (1.0 - tail_mass)
    table = build_cdf_table(pmfs, np.full(C, tail_mass), lengths, precision)
    table.offset = mins.astype(np.int32)
    return table


_SYNTH_TYPES = {
    "channel_bias": 0, "deconv": 1, "igdn": 2, "relu": 3,
    "conv": 4, "gdn": 5, "lrelu": 6,
}


def _gdn_effective(raw: np.ndarray, minimum: float) -> np.ndarray:
    """GDN's square-root re-parameterised beta/gamma resolved to their
    effective values, so the C++ GDN is plain."""
    pedestal = (2.0 ** -18) ** 2
    bound = (minimum + pedestal) ** 0.5
    r = np.maximum(np.asarray(raw, np.float64), bound)
    return (r * r - pedestal).astype(np.float32)


def _channel_bias_blob(bias: np.ndarray) -> bytes:
    b = np.asarray(bias, np.float32).reshape(-1)
    return struct.pack("<ii", _SYNTH_TYPES["channel_bias"], b.size) + b.tobytes()


def _write_crs(path: str, layers, magic: bytes = b"CRS1") -> str:
    with open(path, "wb") as f:
        f.write(magic)
        f.write(struct.pack("<i", len(layers)))
        for blob in layers:
            f.write(blob)
    return path


def _network_blobs(stack: nn.Module, dtype: str = "f32") -> list:
    """A ``_ConvStack``'s CRS layer blobs, from its flax params subtree.

    ``dtype="int16"`` gives the quantized-weights variant (magic CRSq):
    conv/deconv kernels as int16 with one float32 dequantize scale a
    layer, which the C++ engine runs in int16 x int16 -> int64 arithmetic;
    GDN and biases stay float32."""
    if dtype not in ("f32", "int16"):
        raise ValueError(f"unsupported export dtype {dtype!r}")
    params = to_flax_params(stack, dict(stack.named_parameters()))
    layers = []
    for i, spec in enumerate(stack.specs):
        kind = spec[0]
        if kind in ("deconv", "conv"):
            p = params[f"l{i}"]["conv"]
            kern = np.asarray(p["kernel"], np.float32)  # (kh, kw, cin, cout)
            bias = np.asarray(p["bias"], np.float32)
            if kind == "deconv":  # flax applies a ConvTranspose kernel flipped
                kern = kern[::-1, ::-1]
            kh, kw, cin, cout = kern.shape
            if kh != kw:
                raise ValueError("square kernels only")
            if dtype == "int16":
                wscale = float(np.abs(kern).max()) / 32767.0 or 1.0
                kq = np.clip(np.rint(kern / wscale), -32767, 32767).astype(np.int16)
                payload = struct.pack("<f", wscale) + np.ascontiguousarray(kq).tobytes()
            else:
                payload = np.ascontiguousarray(kern).tobytes()
            layers.append(b"".join([struct.pack("<i", _SYNTH_TYPES[kind]),
                                    struct.pack("<iiii", cin, cout, kh, spec[3]),
                                    payload, bias.tobytes()]))
        elif kind in ("gdn", "igdn"):
            p = params[f"l{i}"]
            beta = _gdn_effective(p["beta"], 1e-6)
            gamma = _gdn_effective(p["gamma"], 0.0)  # (out, in) row-major
            layers.append(b"".join([struct.pack("<ii", _SYNTH_TYPES[kind], beta.size),
                                    beta.tobytes(),
                                    np.ascontiguousarray(gamma, np.float32).tobytes()]))
        elif kind in ("relu", "lrelu"):
            layers.append(struct.pack("<i", _SYNTH_TYPES[kind]))
        else:
            raise ValueError(f"layer kind {kind!r} has no standalone equivalent")
    return layers


def _medians_np(medians) -> Optional[np.ndarray]:
    if medians is None:
        return None
    if hasattr(medians, "detach"):
        medians = medians.detach().float().cpu().numpy()
    return np.asarray(medians, np.float32)


def export_synthesis(path: str, stack: nn.Module, medians=None, dtype: str = "f32") -> str:
    """The g_s synthesis stack as the CRS weights file the standalone C++
    decoder runs (``decode-full``); ``medians`` (C,), the EB dequantize
    offsets, go first as a channel-bias layer. ``dtype="int16"`` writes
    the int16 engine's CRSq file."""
    m = _medians_np(medians)
    layers = [] if m is None else [_channel_bias_blob(m)]
    layers.extend(_network_blobs(stack, dtype))
    return _write_crs(path, layers, b"CRSq" if dtype == "int16" else b"CRS1")


def export_analysis(path: str, stack: nn.Module, medians=None, dtype: str = "f32") -> str:
    """The g_a analysis stack as the CRS weights file of the standalone
    C++ encoder (``encode-full``), followed by a channel-bias layer of
    -medians, so rounding the output (half to even) gives the EB symbols."""
    layers = _network_blobs(stack, dtype)
    m = _medians_np(medians)
    if m is not None:
        layers.append(_channel_bias_blob(-m))
    return _write_crs(path, layers, b"CRSq" if dtype == "int16" else b"CRS1")


def export_codec(codec, out_dir: str, params: Union[nn.Module, Dict, None] = None,
                 meta: Optional[Dict] = None) -> Dict[str, str]:
    """The portable artifact directory of a codec: eb_tables.bin (and
    gc_tables.bin), quantizers.json and, when ``params`` is given (a model,
    laid out by ``convert.to_flax_params``, or a flax params tree),
    params.npz keyed by flax path."""
    os.makedirs(out_dir, exist_ok=True)
    codec._require_tables()
    paths: Dict[str, str] = {}
    eb_path = os.path.join(out_dir, "eb_tables.bin")
    write_tables_file(eb_path, codec._eb_table)
    paths["eb_tables"] = eb_path
    has_gc = getattr(codec, "_gc_table", None) is not None
    if has_gc:
        gc_path = os.path.join(out_dir, "gc_tables.bin")
        write_tables_file(gc_path, codec._gc_table)
        paths["gc_tables"] = gc_path
    quant = {"precision": 16, "bypass_precision": 4,
             "scale_table": np.asarray(codec.scale_table).tolist() if has_gc else None,
             **(meta or {})}
    qpath = os.path.join(out_dir, "quantizers.json")
    with open(qpath, "w") as f:
        json.dump(quant, f, indent=2)
    paths["quantizers"] = qpath
    if params is not None:
        if isinstance(params, nn.Module):
            params = to_flax_params(params, dict(params.named_parameters()))
        flat: Dict[str, np.ndarray] = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                name = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    walk(v, name)
                else:
                    flat[name] = np.asarray(v)

        walk(params)
        ppath = os.path.join(out_dir, "params.npz")
        np.savez(ppath, **flat)
        paths["params"] = ppath
    return paths
