"""External classical-codec wrappers invoked through subprocesses.

Counterpart of ``cra5_tpu/tools/ext_codecs.py``: each codec is a small
command builder over one of two drivers, a file-to-file driver (PNG in, PNG
out: BPG, TFCI) and a raw planar YUV 4:4:4 driver (VTM, HM, AV1), plus the
video codecs over frame-folder clips (x264 / x265 through ffmpeg, VTM and
HM over one YUV stream). The RGB <-> YCbCr conversion of the YUV driver is
the port's ``data/transforms.py`` on the host, and writes the JAX
package's bytes; the metrics are the port's ``metrics.py`` on each codec's
``device`` (the card unless the caller asks for the CPU). Every codec is
gated on its binary (``available()``), raises ``CodecUnavailable`` naming
the missing one, and takes explicit encoder/decoder paths, so tests can
substitute mock binaries. None of the binaries ships with the repository.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.transforms import rgb2ycbcr, ycbcr2rgb
from .bench import rgb_metrics as _metrics


class CodecUnavailable(RuntimeError):
    """The external binary backing a codec is not on this machine."""


def run_command(cmd: Sequence, ignore_returncodes: Sequence[int] = ()) -> str:
    cmd = [str(c) for c in cmd]
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0 and proc.returncode not in ignore_returncodes:
        raise RuntimeError(
            f"command failed ({proc.returncode}): {' '.join(cmd)}\n"
            + proc.stderr.decode("utf-8", "replace")
        )
    return proc.stdout.decode("utf-8", "replace")


def _require(binary: str, what: str) -> str:
    """Resolve ``binary`` on PATH or as an explicit path, else raise."""
    resolved = shutil.which(binary) or (binary if os.path.isfile(binary) else None)
    if resolved is None:
        raise CodecUnavailable(
            f"{what} needs '{binary}', which is neither on PATH nor an "
            "existing file; install it or pass an explicit path"
        )
    return resolved


def _rgb_to_yuv444_u8(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (3, H, W) uint8 planar YCbCr444."""
    rgb = torch.from_numpy(np.ascontiguousarray(rgb_u8.transpose(2, 0, 1)[None])).float() / 255.0
    ycc = torch.clamp(rgb2ycbcr(rgb), 0.0, 1.0).numpy()[0]
    return (ycc * 255.0 + 0.5).astype(np.uint8)


def _yuv444_u8_to_rgb(yuv_u8: np.ndarray) -> np.ndarray:
    """(3, H, W) uint8 planar YCbCr444 -> (H, W, 3) uint8 RGB."""
    ycc = torch.from_numpy(np.ascontiguousarray(yuv_u8[None])).float() / 255.0
    rgb = torch.clamp(ycbcr2rgb(ycc), 0.0, 1.0).numpy()[0]
    return (rgb * 255.0 + 0.5).astype(np.uint8).transpose(1, 2, 0)


class ExternalCodec:
    """Base: run() returns the per-image result dict (bpp, encoding_time,
    decoding_time, psnr-rgb, ms-ssim-rgb), the metrics on ``device``."""

    name = "external"
    quality_range = (0, 100)

    def available(self) -> bool:
        try:
            self._check()
            return True
        except CodecUnavailable:
            return False

    def _check(self) -> None:
        raise NotImplementedError

    def _validate_quality(self, quality: int) -> None:
        lo, hi = self.quality_range
        if not lo <= int(quality) <= hi:
            raise ValueError(f"{self.name}: quality {quality} outside [{lo}, {hi}]")

    def run(self, img, quality: int) -> Dict[str, float]:
        raise NotImplementedError


class FileImageCodec(ExternalCodec):
    """Driver for codecs whose binaries read and write image files."""

    fmt = ".bin"

    def encode_cmd(self, in_path: str, quality: int, out_path: str) -> List:
        raise NotImplementedError

    def decode_cmd(self, out_path: str, rec_path: str) -> List:
        raise NotImplementedError

    def run(self, img, quality: int) -> Dict[str, float]:
        self._check()
        self._validate_quality(quality)
        org = np.asarray(img.convert("RGB"), np.uint8)
        with tempfile.TemporaryDirectory(prefix="cra5_bench_") as tmp:
            in_path = os.path.join(tmp, "in.png")
            out_path = os.path.join(tmp, "out" + self.fmt)
            rec_path = os.path.join(tmp, "rec.png")
            img.convert("RGB").save(in_path, format="PNG")

            t0 = time.time()
            run_command(self.encode_cmd(in_path, quality, out_path))
            enc_time = time.time() - t0
            nbytes = os.path.getsize(out_path)

            t0 = time.time()
            run_command(self.decode_cmd(out_path, rec_path))
            dec_time = time.time() - t0

            from PIL import Image

            rec = np.asarray(Image.open(rec_path).convert("RGB"), np.uint8)
        out = {
            "bpp": nbytes * 8.0 / (org.shape[0] * org.shape[1]),
            "encoding_time": enc_time,
            "decoding_time": dec_time,
        }
        out.update(_metrics(org, rec, self.device))
        return out


class YUVImageCodec(ExternalCodec):
    """Driver for codecs whose binaries read and write raw planar YUV444."""

    fmt = ".bin"

    def encode_cmd(self, yuv_path: str, quality: int, out_path: str,
                   width: int, height: int) -> List:
        raise NotImplementedError

    def decode_cmd(self, out_path: str, yuv_path: str) -> List:
        raise NotImplementedError

    def run(self, img, quality: int) -> Dict[str, float]:
        self._check()
        self._validate_quality(quality)
        org = np.asarray(img.convert("RGB"), np.uint8)
        yuv = _rgb_to_yuv444_u8(org)
        height, width = yuv.shape[1:]
        with tempfile.TemporaryDirectory(prefix="cra5_bench_") as tmp:
            yuv_path = os.path.join(tmp, "in.yuv")
            out_path = os.path.join(tmp, "out" + self.fmt)
            dec_path = os.path.join(tmp, "dec.yuv")
            Path(yuv_path).write_bytes(yuv.tobytes())

            t0 = time.time()
            run_command(self.encode_cmd(yuv_path, quality, out_path, width, height))
            enc_time = time.time() - t0
            nbytes = os.path.getsize(out_path)

            t0 = time.time()
            run_command(self.decode_cmd(out_path, dec_path))
            dec_time = time.time() - t0

            rec_yuv = np.fromfile(dec_path, dtype=np.uint8)
        if rec_yuv.size != yuv.size:
            raise RuntimeError(
                f"{self.name}: decoded YUV size {rec_yuv.size} != expected {yuv.size}"
            )
        rec = _yuv444_u8_to_rgb(rec_yuv.reshape(yuv.shape))
        out = {
            "bpp": nbytes * 8.0 / (height * width),
            "encoding_time": enc_time,
            "decoding_time": dec_time,
        }
        out.update(_metrics(org, rec, self.device))
        return out


class BPG(FileImageCodec):
    """BPG: bpgenc / bpgdec."""

    name = "bpg"
    fmt = ".bpg"
    quality_range = (0, 51)

    def __init__(self, encoder_path: str = "bpgenc", decoder_path: str = "bpgdec",
                 subsampling: str = "444", bitdepth: str = "8",
                 color_mode: str = "ycbcr", hevc_impl: str = "x265", device=None):
        self.device = device
        self.encoder_path = encoder_path
        self.decoder_path = decoder_path
        self.subsampling = subsampling
        self.bitdepth = bitdepth
        self.color_mode = color_mode
        self.hevc_impl = hevc_impl

    def _check(self) -> None:
        self.encoder_path = _require(self.encoder_path, "bpg")
        self.decoder_path = _require(self.decoder_path, "bpg")

    def encode_cmd(self, in_path, quality, out_path):
        return [self.encoder_path, "-o", out_path, "-q", int(quality),
                "-f", self.subsampling, "-e", self.hevc_impl,
                "-c", self.color_mode, "-b", self.bitdepth, in_path]

    def decode_cmd(self, out_path, rec_path):
        return [self.decoder_path, "-o", rec_path, out_path]


class TFCI(FileImageCodec):
    """The tensorflow/compression tfci.py models."""

    name = "tfci"
    fmt = ".tfci"
    quality_range = (1, 8)
    models = ("bmshj2018-factorized-mse", "bmshj2018-hyperprior-mse",
              "mbt2018-mean-mse")

    def __init__(self, tfci_script: str, model: str = "bmshj2018-factorized-mse", device=None):
        self.device = device
        if model not in self.models:
            raise ValueError(f"unknown tfci model {model!r}; have {self.models}")
        self.tfci_script = tfci_script
        self.model = model

    def _check(self) -> None:
        if not os.path.isfile(self.tfci_script):
            raise CodecUnavailable(
                f"tfci needs the tfci.py script; {self.tfci_script!r} does not exist"
            )

    def encode_cmd(self, in_path, quality, out_path):
        return [sys.executable, self.tfci_script, "compress",
                f"{self.model}-{int(quality)}", in_path, out_path]

    def decode_cmd(self, out_path, rec_path):
        return [sys.executable, self.tfci_script, "decompress", out_path, rec_path]


class VTM(YUVImageCodec):
    """The VVC reference software."""

    name = "vtm"
    quality_range = (0, 63)
    encoder_name = "EncoderAppStatic"
    decoder_name = "DecoderAppStatic"

    def __init__(self, build_dir: str, config_path: str, device=None):
        self.device = device
        self.encoder_path = os.path.join(build_dir, self.encoder_name)
        self.decoder_path = os.path.join(build_dir, self.decoder_name)
        self.config_path = config_path
        self._extra_enc_flags: List[str] = []

    def _check(self) -> None:
        self.encoder_path = _require(self.encoder_path, self.name)
        self.decoder_path = _require(self.decoder_path, self.name)
        if not os.path.isfile(self.config_path):
            raise CodecUnavailable(f"{self.name} config {self.config_path!r} missing")

    def encode_cmd(self, yuv_path, quality, out_path, width, height):
        return [self.encoder_path, "-i", yuv_path, "-c", self.config_path,
                "-q", int(quality), "-o", os.devnull, "-b", out_path,
                "-wdt", width, "-hgt", height, "-fr", 1, "-f", 1,
                "--InputChromaFormat=444", "--InputBitDepth=8",
                "--ConformanceWindowMode=1", *self._extra_enc_flags]

    def decode_cmd(self, out_path, yuv_path):
        return [self.decoder_path, "-b", out_path, "-o", yuv_path, "-d", 8]


class HM(VTM):
    """The HEVC reference software."""

    name = "hm"
    quality_range = (0, 51)
    encoder_name = "TAppEncoderStatic"
    decoder_name = "TAppDecoderStatic"

    def __init__(self, build_dir: str, config_path: str, device=None):
        super().__init__(build_dir, config_path, device)
        self._extra_enc_flags = ["--SEIDecodedPictureHash", "--Level=5.1",
                                 "--CUNoSplitIntraACT=0", "--ConformanceMode=1"]


class AV1(YUVImageCodec):
    """The AOM reference software."""

    name = "av1"
    fmt = ".webm"
    quality_range = (0, 63)

    def __init__(self, build_dir: str, device=None):
        self.device = device
        self.encoder_path = os.path.join(build_dir, "aomenc")
        self.decoder_path = os.path.join(build_dir, "aomdec")

    def _check(self) -> None:
        self.encoder_path = _require(self.encoder_path, "av1")
        self.decoder_path = _require(self.decoder_path, "av1")

    def encode_cmd(self, yuv_path, quality, out_path, width, height):
        return [self.encoder_path, "-w", width, "-h", height, "--fps=1/1",
                "--limit=1", "--input-bit-depth=8", "--cpu-used=0",
                "--threads=1", "--passes=2", "--end-usage=q",
                f"--cq-level={int(quality)}", "--i444", "--skip=0",
                "--tune=psnr", "--psnr", "--bit-depth=8",
                "-o", out_path, yuv_path]

    def decode_cmd(self, out_path, yuv_path):
        return [self.decoder_path, out_path, "-o", yuv_path, "--rawvideo",
                "--output-bit-depth=8"]


# ---------------------------------------------------------------------------
# Video codecs: a frame-folder clip in, its bpp and per-frame metrics out.
# The ffmpeg codecs take an image2 sequence directly; the YUV codecs
# concatenate the frames into one raw stream.
# ---------------------------------------------------------------------------


class FfmpegVideoCodec(ExternalCodec):
    """x264 / x265 through ffmpeg."""

    vcodec = "h264"
    quality_range = (0, 51)
    extra_enc: List[str] = []

    def __init__(self, ffmpeg: str = "ffmpeg", preset: str = "medium", device=None):
        self.device = device
        self.ffmpeg = ffmpeg
        self.preset = preset

    def _check(self) -> None:
        self.ffmpeg = _require(self.ffmpeg, self.name)

    def run_clip(self, frame_paths: Sequence[str], quality: int) -> Dict[str, float]:
        self._check()
        self._validate_quality(quality)
        from PIL import Image

        orgs = [np.asarray(Image.open(p).convert("RGB"), np.uint8) for p in frame_paths]
        h, w = orgs[0].shape[:2]
        with tempfile.TemporaryDirectory(prefix="cra5_vbench_") as tmp:
            for i, p in enumerate(frame_paths):
                Image.open(p).convert("RGB").save(os.path.join(tmp, f"in_{i:05d}.png"))
            out_path = os.path.join(tmp, "out.mp4")
            t0 = time.time()
            run_command([self.ffmpeg, "-y", "-framerate", 1, "-i",
                         os.path.join(tmp, "in_%05d.png"), "-c:v", self.vcodec,
                         "-crf", int(quality), "-preset", self.preset, "-bf", 0,
                         *self.extra_enc, "-pix_fmt", "yuv444p", out_path])
            enc_time = time.time() - t0
            nbytes = os.path.getsize(out_path)
            t0 = time.time()
            run_command([self.ffmpeg, "-y", "-i", out_path,
                         os.path.join(tmp, "rec_%05d.png")])
            dec_time = time.time() - t0
            recs = [
                np.asarray(Image.open(os.path.join(tmp, f"rec_{i + 1:05d}.png"))
                           .convert("RGB"), np.uint8)
                for i in range(len(frame_paths))
            ]
        per_frame = [_metrics(o, r, self.device) for o, r in zip(orgs, recs)]
        out = {
            "bpp": nbytes * 8.0 / (h * w * len(frame_paths)),
            "encoding_time": enc_time,
            "decoding_time": dec_time,
        }
        for k in per_frame[0]:
            out[k] = float(np.mean([m[k] for m in per_frame]))
        return out


class X264(FfmpegVideoCodec):
    name = "x264"
    vcodec = "h264"


class X265(FfmpegVideoCodec):
    name = "x265"
    vcodec = "hevc"
    extra_enc = ["-x265-params", "bframes=0"]


class VTMVideo(VTM):
    """VTM over a frame-folder clip: one YUV444 stream, -f n_frames."""

    def run_clip(self, frame_paths: Sequence[str], quality: int) -> Dict[str, float]:
        self._check()
        self._validate_quality(quality)
        from PIL import Image

        orgs = [np.asarray(Image.open(p).convert("RGB"), np.uint8) for p in frame_paths]
        yuvs = [_rgb_to_yuv444_u8(o) for o in orgs]
        height, width = yuvs[0].shape[1:]
        n = len(frame_paths)
        with tempfile.TemporaryDirectory(prefix="cra5_vbench_") as tmp:
            yuv_path = os.path.join(tmp, "in.yuv")
            out_path = os.path.join(tmp, "out.bin")
            dec_path = os.path.join(tmp, "dec.yuv")
            Path(yuv_path).write_bytes(b"".join(y.tobytes() for y in yuvs))
            cmd = self.encode_cmd(yuv_path, quality, out_path, width, height)
            cmd[cmd.index("-f") + 1] = n  # frames in the sequence
            t0 = time.time()
            run_command(cmd)
            enc_time = time.time() - t0
            nbytes = os.path.getsize(out_path)
            t0 = time.time()
            run_command(self.decode_cmd(out_path, dec_path))
            dec_time = time.time() - t0
            rec_yuv = np.fromfile(dec_path, dtype=np.uint8)
        expected = n * 3 * height * width
        if rec_yuv.size != expected:
            raise RuntimeError(
                f"{self.name}: decoded YUV size {rec_yuv.size} != expected {expected}"
            )
        recs = [
            _yuv444_u8_to_rgb(f) for f in rec_yuv.reshape(n, 3, height, width)
        ]
        per_frame = [_metrics(o, r, self.device) for o, r in zip(orgs, recs)]
        out = {
            "bpp": nbytes * 8.0 / (height * width * n),
            "encoding_time": enc_time,
            "decoding_time": dec_time,
        }
        for k in per_frame[0]:
            out[k] = float(np.mean([m[k] for m in per_frame]))
        return out


class HMVideo(VTMVideo, HM):
    pass


def build_image_codec(name: str, args) -> Optional[ExternalCodec]:
    """An external image codec from the bench CLI's args (its metrics on
    ``args.device``), or None for the PIL-backed names."""
    dev = getattr(args, "device", None)
    if name == "bpg":
        return BPG(encoder_path=args.encoder_path or "bpgenc",
                   decoder_path=args.decoder_path or "bpgdec", device=dev)
    if name == "tfci":
        if not args.tfci_script:
            raise CodecUnavailable("tfci requires --tfci-script PATH")
        return TFCI(args.tfci_script, model=args.tfci_model, device=dev)
    if name in ("vtm", "hm"):
        if not (args.build_dir and args.codec_config):
            raise CodecUnavailable(f"{name} requires --build-dir and --codec-config")
        cls = VTM if name == "vtm" else HM
        return _paths(cls(args.build_dir, args.codec_config, device=dev), args)
    if name == "av1":
        if not args.build_dir:
            raise CodecUnavailable("av1 requires --build-dir")
        return _paths(AV1(args.build_dir, device=dev), args)
    return None


def build_video_codec(name: str, args) -> Optional[ExternalCodec]:
    """An external video codec from the video bench CLI's args (its metrics
    on ``args.device``), or None for the PIL-backed names."""
    dev = getattr(args, "device", None)
    if name in ("x264", "x265"):
        cls = X264 if name == "x264" else X265
        return cls(ffmpeg=args.encoder_path or "ffmpeg", preset=args.preset, device=dev)
    if name in ("vtm", "hm"):
        if not (args.build_dir and args.codec_config):
            raise CodecUnavailable(f"{name} requires --build-dir and --codec-config")
        cls = VTMVideo if name == "vtm" else HMVideo
        return _paths(cls(args.build_dir, args.codec_config, device=dev), args)
    return None


def _paths(codec: ExternalCodec, args) -> ExternalCodec:
    """The CLI's --encoder-path / --decoder-path over a build dir's binaries."""
    if args.encoder_path:
        codec.encoder_path = args.encoder_path
    if args.decoder_path:
        codec.decoder_path = args.decoder_path
    return codec
