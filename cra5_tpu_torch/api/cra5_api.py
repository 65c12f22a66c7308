"""The user-facing facade: an ERA5 timestep to a ``.bin`` archive and back.

Counterpart of ``cra5_tpu/api/cra5_api.py``, method for method:
``encode_to_latent``, ``latent_to_bin``, ``encode_era5_as_bin``,
``bin_to_latent``, ``latent_to_reconstruction``, ``decode_from_bin``,
``read_data_from_nc``, ``get_mean_std``, ``normalization``,
``de_normalization``, ``show_image``, ``show_latent`` and
``download_era5_data`` (``api/downloader.py``, ``cdsapi`` imported at first
use).

    api = cra5_api(model_version=268, coder="v1")  # on the card, float32
    api.encode_era5_as_bin("2024-01-01T00:00:00", save_root="data")
    x = api.decode_from_bin("2024-01-01T00:00:00")["x_hat"]

``config`` is a config file read by ``Config.fromfile`` (default:
``configs/cra5_268v.py``), as in the JAX package, or a mapping of the same
keys. ``coder="v2"`` (default) writes the lane-rANS streams (CRX2) into the
``.bin`` framing; ``coder="v1"`` writes and reads the serial rANS streams
of the published CRA5 archives. The model runs on ``device`` (default: the
card) in ``dtype`` (default float32, as the JAX package). Weights come
from a file of the port's own ``train/checkpoints.save_variables`` format,
or from the seeded init. Without NetCDF files (or without ``xarray``) a
timestep is a synthetic field keyed by ``hash(time_stamp)``; ``hash`` of a
``str`` is salted per process, so that field is the same only within one
process, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.vaeformer import VAEformer, VAEformerCodec, vaeformer_268, vaeformer_tiny
from ..train.checkpoints import load_variables
from ..utils.config import Config
from . import era5
from .bitstream import load_bin, save_bin

_HERE = os.path.dirname(os.path.abspath(__file__))


class cra5_api:
    def __init__(
        self,
        config: Union[str, Mapping[str, Any], None] = None,
        local_root: Optional[str] = None,
        weights: Optional[str] = None,
        model_version: int = 268,
        coder: str = "v2",
        dtype=torch.float32,
        seed: int = 0,
        device=None,
    ):
        if config is None or isinstance(config, (str, os.PathLike)):
            path = config or os.path.join(_HERE, "configs", "cra5_268v.py")
            self.cfg = Config.fromfile(os.fspath(path)).to_dict()
        else:
            self.cfg = dict(config)
        self.local_root = local_root or os.path.join(os.getcwd(), "data")
        self.mean, self.std = era5.load_mean_std(self.cfg)
        self.channels_to_vname, self.vname_to_channels = era5.channel_vname_mapping(self.cfg)

        if model_version == 268:
            model_cfg = vaeformer_268()
        elif model_version == -1:  # tiny, for tests
            model_cfg = vaeformer_tiny()
        else:
            raise ValueError(f"unknown model_version {model_version}")
        self.model_cfg = model_cfg
        if model_cfg.in_chans != self.mean.shape[0]:
            # reduced-channel variants (the tiny test model) take the
            # leading channels' statistics
            self.mean = self.mean[: model_cfg.in_chans]
            self.std = self.std[: model_cfg.in_chans]
        self.device = resolve_device(device)
        self.net = VAEformer(model_cfg, dtype=dtype, device=self.device)
        if weights is not None:
            self._load_weights(weights)
        else:
            self.net.reset_parameters(seed)
        self.codec = VAEformerCodec(self.net, coder=coder)
        self._downloader = None

    # -- weights -----------------------------------------------------------
    @torch.no_grad()
    def _load_weights(self, path: str) -> None:
        params = load_variables(path, model=self.net)  # .pt, or the JAX package's .msgpack
        own = dict(self.net.named_parameters())
        if set(own) != set(params):
            raise ValueError(f"{path}: parameter names differ from {self.model_cfg.name}'s")
        for name, p in own.items():
            if tuple(params[name].shape) != tuple(p.shape):
                raise ValueError(f"{path}: {name} has shape {tuple(params[name].shape)}, "
                                 f"the model {tuple(p.shape)}")
            p.copy_(params[name])

    # -- data --------------------------------------------------------------
    def download_era5_data(self, time_stamp: str, save_root: Optional[str] = None):
        from .downloader import era5_downloader

        if self._downloader is None:
            self._downloader = era5_downloader()
        return self._downloader.get_form_timestamp(
            time_stamp=time_stamp, local_root=save_root or self.local_root)

    def read_data_from_nc(self, time_stamp: str) -> np.ndarray:
        return era5.read_data_from_nc(self.cfg, self.local_root, time_stamp)

    def _read_or_synthesize(self, time_stamp: str) -> np.ndarray:
        try:
            return self.read_data_from_nc(time_stamp)
        except (RuntimeError, FileNotFoundError):
            # no NetCDF stack or no file: a synthetic field keyed by the
            # timestamp (tests, benchmarks, demos)
            seed = abs(hash(time_stamp)) % (2**31)
            rng = np.random.default_rng(seed)
            x = rng.standard_normal((self.mean.shape[0], *self.model_cfg.img_size), dtype=np.float32)
            return x * self.std[:, None, None] + self.mean[:, None, None]

    # -- normalization -----------------------------------------------------
    def get_mean_std(self):
        return self.mean, self.std

    def normalization(self, data: np.ndarray) -> np.ndarray:
        return era5.normalize(data, self.mean, self.std)

    def de_normalization(self, data) -> np.ndarray:
        if isinstance(data, torch.Tensor):
            data = data.float().cpu().numpy()
        return era5.denormalize(np.asarray(data), self.mean, self.std)

    # -- encode ------------------------------------------------------------
    def _quantized_latent(self, y: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            sym = self.net.symbols_from_latent(y)
        return sym["y_sym"].to(torch.float32) + sym["means"]

    def encode_to_latent(self, time_stamp: str, save_root: Optional[str] = None,
                         latent_type: str = "float") -> torch.Tensor:
        x = self.normalization(self._read_or_synthesize(time_stamp))[None]
        y = self.codec.encode_latent(x)
        if latent_type == "float":
            return y
        if latent_type == "quantized":
            return self._quantized_latent(y)
        raise ValueError(f"unknown latent_type {latent_type!r}")

    def latent_to_bin(self, y) -> Dict[str, Any]:
        return self.codec.compress_from_latent(y)

    def encode_era5_as_bin(self, time_stamp: str, save_root: Optional[str] = None,
                           return_format: str = "bin"):
        """Write ``{save_root}/CRA5/{year}/{time_stamp}.bin``; returns the
        codec's output, the stage seconds and the path."""
        save_root = save_root or self.local_root
        st1 = time.time()
        x = self.normalization(self._read_or_synthesize(time_stamp))[None]
        st2 = time.time()
        if return_format == "latent":
            return self.codec.encode_latent(x)
        if return_format == "quantized":
            return self._quantized_latent(self.codec.encode_latent(x))

        output = self.codec.compress(x)
        st3 = time.time()
        year = time_stamp.split("-")[0]
        file_url = f"{save_root}/CRA5/{year}/{time_stamp}.bin"
        save_bin(file_url, [output["strings"][0][0], output["strings"][1][0]], output["z_shape"])
        st4 = time.time()
        return dict(output=output, reading_time=st2 - st1, encoding_time=st3 - st2,
                    saving_time=st4 - st3, save_path=file_url)

    # -- decode ------------------------------------------------------------
    def _bin_path(self, time_stamp: Optional[str], custom_path: Optional[str]) -> str:
        if custom_path is not None:
            return custom_path
        if time_stamp is None:
            raise ValueError("give a time_stamp or a custom_path")
        return f"{self.local_root}/CRA5/{time_stamp[:4]}/{time_stamp}.bin"

    def bin_to_latent(self, bin_path: Optional[str] = None,
                      time_stamp: Optional[str] = None) -> torch.Tensor:
        strings, shape = load_bin(self._bin_path(time_stamp, bin_path))
        return self.codec.decompress(strings, shape, return_format="latent")

    def latent_to_reconstruction(self, y_hat) -> torch.Tensor:
        return self.codec.decode_latent(y_hat)

    def decode_from_bin(self, time_stamp: Optional[str] = None, custom_path: Optional[str] = None,
                        return_format: str = "de_normalized"):
        """Read a ``.bin`` and reconstruct: the de-normalized (C, H, W)
        field as numpy (default), the normalized (1, C, H, W) tensor
        (``"normalized"``) or the latent (``"latent"``)."""
        path = self._bin_path(time_stamp, custom_path)
        t0 = time.time()
        strings, shape = load_bin(path)
        if return_format == "latent":
            return self.codec.decompress(strings, shape, return_format="latent")
        out = self.codec.decompress(strings, shape)
        if return_format == "normalized":
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return dict(x_hat=out["x_hat"], decoding_time=time.time() - t0)
        x_hat = self.de_normalization(out["x_hat"][0])
        return dict(x_hat=x_hat, decoding_time=time.time() - t0)

    # -- visualization -----------------------------------------------------
    def show_image(self, reconstruct_data, time_stamp: str,
                   show_variables=("z_500", "q_500", "u_500", "v_500", "t_500", "w_500"),
                   save_images: bool = True, save_path: Optional[str] = None) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        input_data = self._read_or_synthesize(time_stamp)
        if isinstance(reconstruct_data, torch.Tensor):
            reconstruct_data = reconstruct_data.float().cpu().numpy()
        reconstruct_data = np.asarray(reconstruct_data)
        fig, axs = plt.subplots(len(show_variables), 3, figsize=(20, 3 * len(show_variables)))
        if len(show_variables) == 1:
            axs = axs[None, :]
        for i, vname in enumerate(show_variables):
            ch = self.vname_to_channels[vname]
            ori, rec = input_data[ch], reconstruct_data[ch]
            for j, (img, tag) in enumerate(
                [(ori, "Original"), (rec, "Reconstructed"), (np.abs(ori - rec), "Difference")]
            ):
                im = axs[i, j].imshow(img, cmap="jet")
                axs[i, j].set_title(f"{vname}_{tag}")
                fig.colorbar(im, ax=axs[i, j])
        plt.tight_layout()
        fig_path = (
            f"{save_path}/{time_stamp}_reconstruction.png" if save_path
            else f"{self.local_root}/CRA5_vis/{time_stamp[:4]}/{time_stamp}_reconstruction.png"
        )
        os.makedirs(os.path.dirname(fig_path), exist_ok=True)
        if save_images:
            plt.savefig(fig_path)
        plt.close(fig)
        return fig_path

    def show_latent(self, latent, time_stamp: str, show_channels=(0, 10, 20, 30, 40, 50, 60, 70),
                    save_images: bool = True, save_path: Optional[str] = None) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if isinstance(latent, torch.Tensor):
            latent = latent.float().cpu().numpy()
        latent = np.asarray(latent)
        if latent.ndim == 4:
            latent = latent[0]
        rows = max(1, len(show_channels) // 4)
        fig, axs = plt.subplots(rows, 4, figsize=(24, 3 * rows))
        axs = np.atleast_1d(axs).flatten()
        for i, ch in enumerate(show_channels):
            im = axs[i].imshow(latent[ch], cmap="jet")
            axs[i].set_title(f"Channel_{ch}")
            fig.colorbar(im, ax=axs[i])
        plt.tight_layout()
        fig_path = (
            f"{save_path}/{time_stamp}_latent.png" if save_path
            else f"{self.local_root}/CRA5_vis/{time_stamp[:4]}/{time_stamp}_latent.png"
        )
        os.makedirs(os.path.dirname(fig_path), exist_ok=True)
        if save_images:
            plt.savefig(fig_path)
        plt.close(fig)
        return fig_path
