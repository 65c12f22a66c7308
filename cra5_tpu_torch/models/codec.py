"""Compress/decompress orchestration for the image-codec zoo.

Counterpart of ``cra5_tpu/models/codec.py``. The models of ``google.py``
and ``waseda.py`` hold their weights and compute on their device; a codec
owns the derived entropy-coding state (integer CDF tables and lane coders)
and moves only int32 symbols and the bytes across. Strings nest as the
reference's, [[y_str...], [z_str...]].

Coders: ``coder="v2"`` is the interleaved-lane rANS on the device (K1
encodes; K2 decodes the z streams, the factorized y and y below 2048
lanes; K3 decodes sorted kernel-safe y streams); ``coder="v1"`` is the
serial rANS of the reference's archives on the host (``coder/native.py``).
``ImageCodec`` dispatches every encode before any host transfer and issues
the y stream's upload before the z decode and the hyper pass.
``AutoregressiveCodec`` is host-serial by construction and always uses v1:
its per-pixel loop is the JAX package's numpy loop on the same arrays (the
masked HWIO context kernel and the (cin, cout) 1x1 layers, pulled from the
torch modules), so given the same y and hyper parameters it writes the
same bytes. The JAX package passes ``row_plan=H*W`` to its z decodes, a
promise its row-plan Pallas kernel uses; the port's K2 serves both that
kernel's streams and the generic ones, so no such promise is passed.

``stage_times``: each codec stage is a span (``utils/profiling.py``) named
``compress/<stage>`` or ``decompress/<stage>``; when ``stage_times`` is a
dict, each stage also ends in a device synchronize and adds its host
seconds there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coder import native
from ..coder.lane_coder import LaneCoder, _unwrap_bytes
from ..entropy import build_indexes, eb_update, gc_update, get_scale_table
from ..entropy.cdf import CdfTable
from ..nn.conv import _mask_A_B
from ..utils.profiling import stage_span


class _CodecBase:
    """CDF tables, coders, indexes and stage timing shared by the codecs."""

    def __init__(self, model, coder: str = "v2", scale_table=None):
        if coder not in ("v1", "v2"):
            raise ValueError(f"unknown coder {coder!r}: 'v1' or 'v2'")
        self.model = model
        self.device = model.device
        self.coder = coder
        self.scale_table = (np.asarray(scale_table, np.float32) if scale_table is not None
                            else get_scale_table())
        self._scale_table_dev = torch.as_tensor(self.scale_table, device=self.device)
        self._eb_table: Optional[CdfTable] = None
        self._gc_table: Optional[CdfTable] = None
        self._eb_coder: Optional[LaneCoder] = None
        self._gc_coder: Optional[LaneCoder] = None
        self.stage_times: Optional[Dict[str, float]] = None

    @property
    def kind(self) -> str:
        return getattr(self.model, "CODEC_KIND", "hyper")

    def _stage(self, name: str):
        return stage_span(name, self.stage_times, self.device)

    def update(self, force: bool = False) -> bool:
        """(Re)build the integer CDF tables from the EntropyBottleneck's
        parameters and the scale table (no GC table for a factorized
        model)."""
        if self._eb_table is not None and not force:
            return False
        self.set_tables(eb_update(self.model.entropy_bottleneck.params_numpy()),
                        gc_update(self.scale_table) if self.kind != "factorized" else None)
        return True

    def set_tables(self, eb_table: CdfTable, gc_table: Optional[CdfTable]) -> None:
        """Install CDF tables (and, for v2, their coders on the device)."""
        self._eb_table, self._gc_table = eb_table, gc_table
        if self.coder == "v2":
            self._eb_coder = LaneCoder(eb_table, device=self.device)
            self._gc_coder = None if gc_table is None else LaneCoder(gc_table, device=self.device)

    def _require_tables(self) -> None:
        if self._eb_table is None:
            self.update()

    def _channel_indexes(self, shape) -> torch.Tensor:
        """Per-channel CDF rows of an EntropyBottleneck-coded (B, C, H, W)
        tensor, made on the device (on the caller's stream) at each call."""
        B, C, H, W = (int(s) for s in shape)
        return torch.arange(C, dtype=torch.int32, device=self.device).reshape(
            1, C, 1, 1).expand(B, C, H, W)

    def _gc_indexes(self, scales: torch.Tensor) -> torch.Tensor:
        return build_indexes(scales.float(), self._scale_table_dev)

    @staticmethod
    def _v1_encode(table: CdfTable, sym: torch.Tensor, idx: torch.Tensor) -> List[bytes]:
        """One v1 stream per sample, on the host."""
        sym, idx = sym.cpu().numpy(), idx.cpu().numpy()
        tabs = (table.quantized_cdf, table.cdf_length, table.offset)
        return [native.encode_with_indexes(sym[b], idx[b], *tabs) for b in range(sym.shape[0])]

    def _v1_decode(self, table: CdfTable, strings, idx: torch.Tensor) -> torch.Tensor:
        """One v1 stream per sample decoded on the host; the symbols go to
        the device."""
        idx = idx.cpu().numpy()
        tabs = (table.quantized_cdf, table.cdf_length, table.offset)
        sym = np.stack([native.decode_with_indexes(_unwrap_bytes(strings[b]), idx[b], *tabs)
                        for b in range(idx.shape[0])])
        return torch.from_numpy(sym).to(self.device)

    def _input(self, x) -> torch.Tensor:
        with self._stage("compress/h2d_input"):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def forward(self, x) -> Dict[str, Any]:
        """The model's eval forward: x_hat and the likelihoods."""
        return self.model(torch.as_tensor(x, dtype=torch.float32, device=self.device))


class ImageCodec(_CodecBase):
    """The codec of the factorized and hyperprior zoo models, dispatching on
    the model's ``CODEC_KIND`` ("factorized" | "hyper"): FactorizedPrior(+ReLU),
    ScaleHyperprior, MeanScaleHyperprior, SampledYInBmshj2018, and any model
    with the same device methods."""

    @torch.inference_mode()
    def compress(self, x) -> Dict[str, Any]:
        self._require_tables()
        x = self._input(x)
        with self._stage("compress/encode_symbols"):
            out = self.model.encode_symbols(x)
        if self.kind == "factorized":
            y_sym = out["y_sym"]
            idx = self._channel_indexes(y_sym.shape)
            if self.coder == "v2":
                with self._stage("compress/encode_y"):  # K1
                    handles = self._eb_coder.encode_dispatch_batch(y_sym, idx)
                with self._stage("compress/finalize"):  # to the host, containers
                    y_strings = LaneCoder.encode_finalize_many(handles)
            else:
                with self._stage("compress/encode_y"):  # to the host, serial rANS
                    y_strings = self._v1_encode(self._eb_table, y_sym, idx)
            return {"strings": [y_strings], "shape": tuple(int(s) for s in y_sym.shape[-2:])}

        z_sym, y_sym = out["z_sym"], out["y_sym"]
        B = z_sym.shape[0]
        shape = tuple(int(s) for s in z_sym.shape[-2:])
        z_idx = self._channel_indexes(z_sym.shape)
        if self.coder == "v2":
            # every stream dispatched before any host transfer, then finalized
            with self._stage("compress/encode_z"):  # K1
                handles = self._eb_coder.encode_dispatch_batch(z_sym, z_idx)
            with self._stage("compress/encode_y"):  # GC indexes, sort, merge, K1
                handles += self._gc_coder.encode_dispatch_batch(y_sym, self._gc_indexes(out["scales"]))
            with self._stage("compress/finalize"):
                streams = LaneCoder.encode_finalize_many(handles)
            return {"strings": [streams[B:], streams[:B]], "shape": shape}
        with self._stage("compress/encode_z"):
            z_strings = self._v1_encode(self._eb_table, z_sym, z_idx)
        with self._stage("compress/encode_y"):
            y_strings = self._v1_encode(self._gc_table, y_sym, self._gc_indexes(out["scales"]))
        return {"strings": [y_strings, z_strings], "shape": shape}

    @torch.inference_mode()
    def decompress(self, strings: Sequence, shape: Tuple[int, int]) -> Dict[str, Any]:
        self._require_tables()
        if self.kind == "factorized":
            y_strings = strings[0]
            idx = self._channel_indexes((len(y_strings), self.model.M, int(shape[0]),
                                         int(shape[1])))
            with self._stage("decompress/decode_y"):  # K2 (v2)
                if self.coder == "v2":
                    y_sym = self._eb_coder.decode_batch_to_device(list(y_strings), idx)
                else:
                    y_sym = self._v1_decode(self._eb_table, y_strings, idx)
            with self._stage("decompress/reconstruct"):
                x_hat = self.model.reconstruct(y_sym, None)
            return {"x_hat": x_hat}

        y_strings, z_strings = strings[0], strings[1]
        z_idx = self._channel_indexes((len(z_strings), self.model.N, int(shape[0]),
                                       int(shape[1])))
        if self.coder == "v2":
            # the y bytes go to the device before the z decode and the
            # hyper pass produce their indexes
            with self._stage("decompress/upload_y"):
                y_up = self._gc_coder.upload_batch(list(y_strings))
            with self._stage("decompress/decode_z"):  # K2
                z_sym = self._eb_coder.decode_batch_to_device(list(z_strings), z_idx)
            with self._stage("decompress/hyper"):
                scales, means = self.model.hyper_params_from_z(z_sym)
            with self._stage("decompress/decode_y"):  # GC indexes; K2, or K3 when sorted
                y_sym = self._gc_coder.decode_uploaded_batch(y_up, self._gc_indexes(scales))
        else:
            with self._stage("decompress/decode_z"):
                z_sym = self._v1_decode(self._eb_table, z_strings, z_idx)
            with self._stage("decompress/hyper"):
                scales, means = self.model.hyper_params_from_z(z_sym)
            with self._stage("decompress/decode_y"):
                y_sym = self._v1_decode(self._gc_table, y_strings, self._gc_indexes(scales))
        with self._stage("decompress/reconstruct"):
            x_hat = self.model.reconstruct(y_sym, means)
        return {"x_hat": x_hat}


class AutoregressiveCodec(_CodecBase):
    """The serial raster-scan codec of JointAutoregressiveHierarchicalPriors
    and Cheng2020: analysis, hyper synthesis and synthesis on the device,
    the per-pixel context loop on the host in numpy, the v1 coder always
    (the loop decodes a pixel's symbols at a time)."""

    def __init__(self, model, scale_table=None):
        super().__init__(model, coder="v1", scale_table=scale_table)
        self._st = self.scale_table.astype(np.float64)
        self._load_host_params()

    def _load_host_params(self) -> None:
        """The masked HWIO context kernel and bias, and the (cin, cout) 1x1
        layers of entropy_parameters in layer order, as float32 C-ordered
        arrays: the arrays the JAX package takes from its variables."""
        host = lambda t: np.ascontiguousarray(t.detach().float().cpu().numpy())
        cp = self.model.context_prediction
        k = host(cp.weight).transpose(2, 3, 1, 0)  # OIHW -> HWIO
        self._ctx_kernel = np.ascontiguousarray(k * _mask_A_B(k.shape[:2], "A", *k.shape[2:]))
        self._ctx_bias = host(cp.bias)
        ep = self.model.entropy_parameters
        self._ep_layers = [
            (np.ascontiguousarray(host(getattr(ep, f"l{i}").conv.weight)[:, :, 0, 0].T),
             host(getattr(ep, f"l{i}").conv.bias))
            for i, spec in enumerate(ep.specs) if spec[0] == "conv"]

    def _entropy_parameters_vec(self, x: np.ndarray) -> np.ndarray:
        """x: (..., cin) -> (..., 2M) through the 1x1-conv MLP."""
        for i, (w, b) in enumerate(self._ep_layers):
            x = x @ w + b
            if i < len(self._ep_layers) - 1:
                x = np.where(x >= 0, x, 0.01 * x)
        return x

    def _ctx_at(self, y_hat_pad: np.ndarray, h: int, w: int) -> np.ndarray:
        """The masked context at (h, w); y_hat_pad: (M, H+2p, W+2p)."""
        k = self._ctx_kernel.shape[0]
        patch = y_hat_pad[:, h:h + k, w:w + k]  # (M, k, k)
        return np.einsum("hwio,ihw->o", self._ctx_kernel, patch) + self._ctx_bias

    def _pixel_params(self, y_hat: np.ndarray, params: np.ndarray, h: int, w: int, M: int):
        """(cdf rows, means) at (h, w) from the decoded neighbourhood."""
        gp = self._entropy_parameters_vec(
            np.concatenate([params[:, h, w], self._ctx_at(y_hat, h, w)]))
        scales, means = gp[:M], gp[M:]
        st = self._st
        idx = np.searchsorted(st[:-1], np.maximum(scales, st[0]), side="left").astype(np.int32)
        return idx, means

    @torch.inference_mode()
    def compress(self, x) -> Dict[str, Any]:
        self._require_tables()
        x = self._input(x)
        with self._stage("compress/analysis"):
            out = self.model.analysis(x)
        z_sym = out["z_sym"]
        with self._stage("compress/encode_z"):
            z_strings = self._v1_encode(self._eb_table, z_sym, self._channel_indexes(z_sym.shape))
        with self._stage("compress/hyper"):
            params = self.model.hyper_synthesis(z_sym).float().cpu().numpy()
            y = out["y"].float().cpu().numpy()
        with self._stage("compress/encode_y"):
            y_strings = [self._compress_ar(y[i], params[i]) for i in range(y.shape[0])]
        return {"strings": [y_strings, z_strings],
                "shape": tuple(int(s) for s in z_sym.shape[-2:])}

    def _encode_ar(self, y: np.ndarray, params: np.ndarray):
        """The raster scan of one sample's y (M, H, W): its symbols and cdf
        rows in coding order, and the y_hat the decoder will rebuild."""
        M, H, W = y.shape
        pad = (self._ctx_kernel.shape[0] - 1) // 2
        y_hat = np.zeros((M, H + 2 * pad, W + 2 * pad), np.float32)
        syms_all, idx_all = [], []
        for h in range(H):
            for w in range(W):
                idx, means = self._pixel_params(y_hat, params, h, w, M)
                sym = np.round(y[:, h, w] - means).astype(np.int32)
                y_hat[:, h + pad, w + pad] = sym + means
                syms_all.append(sym)
                idx_all.append(idx)
        return np.concatenate(syms_all), np.concatenate(idx_all), y_hat[:, pad:pad + H, pad:pad + W]

    def _compress_ar(self, y: np.ndarray, params: np.ndarray) -> bytes:
        sym, idx, _ = self._encode_ar(y, params)
        t = self._gc_table
        return native.encode_with_indexes(sym, idx, t.quantized_cdf, t.cdf_length, t.offset)

    @torch.inference_mode()
    def decompress(self, strings: Sequence, shape: Tuple[int, int]) -> Dict[str, Any]:
        self._require_tables()
        y_strings, z_strings = strings[0], strings[1]
        B = len(z_strings)
        with self._stage("decompress/decode_z"):
            z_sym = self._v1_decode(self._eb_table, z_strings, self._channel_indexes(
                (B, self.model.N, int(shape[0]), int(shape[1]))))
        with self._stage("decompress/hyper"):
            params = self.model.hyper_synthesis(z_sym).float().cpu().numpy()
        s = 4  # z -> y upsampling factor
        H, W = int(shape[0]) * s, int(shape[1]) * s
        with self._stage("decompress/decode_y"):
            y_hat = np.stack([self._decompress_ar(_unwrap_bytes(y_strings[i]), params[i], H, W)
                              for i in range(B)])
        with self._stage("decompress/synthesis"):
            x_hat = self.model.synthesis(torch.from_numpy(y_hat).to(self.device))
        return {"x_hat": x_hat}

    def _decompress_ar(self, data: bytes, params: np.ndarray, H: int, W: int) -> np.ndarray:
        M = self.model.M
        pad = (self._ctx_kernel.shape[0] - 1) // 2
        y_hat = np.zeros((M, H + 2 * pad, W + 2 * pad), np.float32)
        t = self._gc_table
        dec = native.StreamingDecoder(data)
        for h in range(H):
            for w in range(W):
                idx, means = self._pixel_params(y_hat, params, h, w, M)
                sym = dec.decode(idx, t.quantized_cdf, t.cdf_length, t.offset)
                y_hat[:, h + pad, w + pad] = sym.astype(np.float32) + means
        return y_hat[:, pad:pad + H, pad:pad + W]


class _SliceCodec(_CodecBase):
    """The skeleton of the codecs that code y as many v2 streams a sample,
    each slice's entropy parameters computed from the slices before it
    (``elic2022.ElicCodec``, ``stf2022.CharmCodec``): the z stream, then
    the subclass's ``_encode_slices`` / ``_decode_slices``. Strings nest as
    [[y...], [z...]], y slice by slice and sample by sample within each.
    The v2 coder always: ``make_codec`` passes no ``coder``, as the JAX
    package's does. K1 is dispatched for every stream as its symbols exist
    and all streams are finalized at the end; on decode every y stream is
    uploaded first."""

    def __init__(self, model, scale_table=None):
        super().__init__(model, coder="v2", scale_table=scale_table)

    def _decode(self, uploaded, idx: torch.Tensor) -> torch.Tensor:
        return self._gc_coder.decode_uploaded_batch(uploaded, idx)

    @torch.inference_mode()
    def compress(self, x) -> Dict[str, Any]:
        self._require_tables()
        x = self._input(x)
        with self._stage("compress/analysis"):
            out = self.model.analysis(x)
        z_sym, y = out["z_sym"], out["y"]
        with self._stage("compress/encode_z"):  # K1
            handles = self._eb_coder.encode_dispatch_batch(z_sym,
                                                           self._channel_indexes(z_sym.shape))
        with self._stage("compress/hyper"):
            hyper = self.model.hyper_params_from_z(z_sym)
        with self._stage("compress/encode_y"):  # per slice: towers, indexes, K1
            handles += self._encode_slices(y, hyper)
        with self._stage("compress/finalize"):
            streams = LaneCoder.encode_finalize_many(handles)
        B = z_sym.shape[0]
        return {"strings": [streams[B:], streams[:B]],
                "shape": tuple(int(s) for s in z_sym.shape[-2:]),
                "y_shape": tuple(int(s) for s in y.shape[-2:])}

    @torch.inference_mode()
    def decompress(self, strings: Sequence, shape, y_shape=None) -> Dict[str, Any]:
        """``y_shape`` defaults to 4 x z's ``shape``."""
        self._require_tables()
        m = self.model
        y_strings, z_strings = strings[0], strings[1]
        B = len(z_strings)
        C = getattr(m, "hyper_channels", m.N)
        with self._stage("decompress/upload_y"):
            ups = self._gc_coder.upload_batch(list(y_strings))
        with self._stage("decompress/decode_z"):  # K2
            z_sym = self._eb_coder.decode_batch_to_device(
                list(z_strings), self._channel_indexes((B, C, int(shape[0]), int(shape[1]))))
        with self._stage("decompress/hyper"):
            hyper = m.hyper_params_from_z(z_sym)
        W = int(shape[1]) * 4 if y_shape is None else int(y_shape[1])
        with self._stage("decompress/decode_y"):  # per slice: towers, indexes, K2/K3
            y_hat = self._decode_slices(ups, B, hyper, W)
        with self._stage("decompress/synthesis"):
            x_hat = m.synthesis(y_hat)
        return {"x_hat": x_hat}


def make_codec(model, coder: str = "v2", scale_table=None):
    """The codec of a zoo model, by its ``CODEC_KIND``."""
    kind = getattr(model, "CODEC_KIND", "hyper")
    if kind == "vaeformer":
        from .vaeformer import VAEformerCodec

        return VAEformerCodec(model, coder=coder, scale_table=scale_table)
    if kind == "autoregressive":
        return AutoregressiveCodec(model, scale_table=scale_table)
    if kind == "elic":  # the v2 coder always: no coder passed, as in the JAX package
        from .elic2022 import ElicCodec

        return ElicCodec(model, scale_table=scale_table)
    if kind == "charm":
        from .stf2022 import CharmCodec

        return CharmCodec(model, scale_table=scale_table)
    return ImageCodec(model, coder=coder, scale_table=scale_table)
