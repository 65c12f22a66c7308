"""Model FLOPs and the window attention's operations and bytes of TCM 2023
from its configuration's shapes, at an input of H x W pixels.

FLOPs: every convolution and matrix product counted as 2 m n k, as the
model computes it: the convolutions of the residual blocks, GDN's 1x1
product, the ConvTransBlocks' 1x1 fusions and residual branches, each Swin
block's qkv and output projections and Q K^T and P V on its padded window
grid, its MLP on the tokens, the SWAtten gates, the cc and lrp transforms.
Not counted: norms, softmax, activations, pixel shuffles, the coder. A
roundtrip is compress (g_a, h_a, both hyper syntheses, the slice chain)
then decompress (both hyper syntheses, the slice chain, g_s).

Attention (``attention_calls``): each Swin block's window attention, one
dict a call in the program's order (``windows``, ``heads``, ``tokens``,
``head_dim``, the window ``w``), as the program's ``swin/attn`` span
records it. Its bound (``attention_bound_s``): a call's operations are
4 tokens^2 head_dim a window and head (Q K^T and P V); its bytes are
float32 q, k and v read and the output written (4 tokens x dim a window)
and the bias table read; the least time is the larger of operations over
the float32 peak and bytes over the memory's, summed over the calls.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from reference import tcm2023 as ref

from .peaks import BYTES_PER_S, FLOPS


class _Count:
    def __init__(self, c: dict):
        self.c = ref.cfg_of(c)
        self.flops = 0
        self.attn: List[Dict[str, int]] = []

    def conv(self, cin, cout, k, H, W, s=1) -> Tuple[int, int]:
        Ho, Wo = -(-H // s), -(-W // s)
        self.flops += 2 * cout * Ho * Wo * cin * k * k
        return Ho, Wo

    def rbs(self, cin, cout, H, W):
        Ho, Wo = self.conv(cin, cout, 3, H, W, 2)
        self.conv(cout, cout, 3, Ho, Wo)
        self.flops += 2 * cout * cout * Ho * Wo  # GDN
        self.conv(cin, cout, 1, H, W, 2)
        return Ho, Wo

    def rbu(self, cin, cout, H, W):
        self.conv(cin, 4 * cout, 3, H, W)
        self.conv(cout, cout, 3, 2 * H, 2 * W)
        self.flops += 2 * cout * cout * 4 * H * W  # IGDN
        self.conv(cin, 4 * cout, 3, H, W)
        return 2 * H, 2 * W

    def block(self, dim, head_dim, w, H, W):
        heads = max(1, dim // head_dim)
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        n, windows = w * w, (Hp // w) * (Wp // w)
        self.flops += 2 * Hp * Wp * dim * 3 * dim + 2 * Hp * Wp * dim * dim  # qkv, proj
        self.flops += 4 * windows * heads * n * n * (dim // heads)  # Q K^T, P V
        self.flops += 2 * 2 * H * W * dim * self.c["mlp_ratio"] * dim  # MLP
        self.attn.append({"windows": windows, "heads": heads, "tokens": n,
                          "head_dim": dim // heads, "w": w})

    def ctb(self, n, head_dim, w, H, W):
        self.conv(2 * n, 2 * n, 1, H, W)
        self.conv(n, n, 3, H, W)
        self.conv(n, n, 3, H, W)
        self.block(n, head_dim, w, H, W)
        self.conv(2 * n, 2 * n, 1, H, W)

    def stage(self, depth, head_dim, w, kind, cout, H, W):
        n = self.c["N"]
        for _ in range(depth):
            self.ctb(n, head_dim, w, H, W)
        if kind == "rbs":
            return self.rbs(2 * n, cout, H, W)
        if kind == "rbu":
            return self.rbu(2 * n, cout, H, W)
        if kind == "conv":
            return self.conv(2 * n, cout, 3, H, W, 2)
        self.conv(2 * n, 4 * cout, 3, H, W)
        return 2 * H, 2 * W

    def unit(self, ch, H, W):
        self.conv(ch, ch // 2, 1, H, W)
        self.conv(ch // 2, ch // 2, 3, H, W)
        self.conv(ch // 2, ch, 1, H, W)

    def swatten(self, cin, cout, H, W):
        c, d = self.c, self.c["atten_inter_dim"]
        self.conv(cin, d, 1, H, W)
        for _ in range(2):
            self.block(d, c["atten_head_dim"], c["window_size"], H, W)
        for _ in range(6):
            self.unit(d, H, W)
        self.conv(d, d, 1, H, W)
        self.conv(d, cout, 1, H, W)

    def cc(self, cin, cout, H, W):
        w1, w2 = self.c["cc_widths"]
        self.conv(cin, w1, 3, H, W)
        self.conv(w1, w2, 3, H, W)
        self.conv(w2, cout, 3, H, W)

    # -- the codec's halves -------------------------------------------------
    def g_a(self, H, W):
        c, N = self.c, self.c["N"]
        H, W = self.rbs(c["in_channel"], 2 * N, H, W)
        for i in range(3):
            H, W = self.stage(c["config"][i], c["head_dim"][i], c["window_size"],
                              "rbs" if i < 2 else "conv", 2 * N if i < 2 else c["M"], H, W)
        return H, W

    def g_s(self, H, W):
        c, N = self.c, self.c["N"]
        H, W = self.rbu(c["M"], 2 * N, H, W)
        for i in range(3):
            H, W = self.stage(c["config"][3 + i], c["head_dim"][3 + i], c["window_size"],
                              "rbu" if i < 2 else "subpel", 2 * N if i < 2 else c["in_channel"],
                              H, W)
        return H, W

    def h_a(self, H, W):
        c = self.c
        H, W = self.rbs(c["M"], 2 * c["N"], H, W)
        return self.stage(c["config"][0], c["hyper_head_dim"], c["hyper_window"], "conv",
                          c["hyper_channels"], H, W)

    def h_s(self, H, W):
        c = self.c
        for _ in range(2):
            h, w = self.rbu(c["hyper_channels"], 2 * c["N"], H, W)
            self.stage(c["config"][3], c["hyper_head_dim"], c["hyper_window"], "subpel", c["M"],
                       h, w)

    def slices(self, H, W):
        c = self.c
        for i in range(c["num_slices"]):
            sup, att, s = ref._slice_dims(c, i)
            for _ in range(2):
                self.swatten(sup, att, H, W)
                self.cc(att, s, H, W)
            self.cc(att + s, s, H, W)

    def compress(self, H, W):
        h, w = self.g_a(H, W)
        zh, zw = self.h_a(h, w)
        self.h_s(zh, zw)
        self.slices(h, w)

    def decompress(self, H, W):
        h, w = -(-H // 16), -(-W // 16)
        self.h_s(-(-h // 4), -(-w // 4))
        self.slices(h, w)
        self.g_s(h, w)


def _counted(c: dict, H: int, W: int, halves) -> _Count:
    n = _Count(c)
    for half in halves:
        getattr(n, half)(H, W)
    return n


def roundtrip_flops(c: dict, H: int, W: int) -> int:
    """compress then decompress of one H x W image."""
    return _counted(c, H, W, ("compress", "decompress")).flops


def attention_calls(c: dict, H: int, W: int, halves=("compress", "decompress")) -> List[dict]:
    return _counted(c, H, W, halves).attn


def attention_bound_s(c: dict, H: int, W: int) -> float:
    """The least time of a roundtrip's window attention (``swin/attn``)."""
    total = 0.0
    for a in attention_calls(c, H, W):
        ops = 4 * a["windows"] * a["heads"] * a["tokens"] ** 2 * a["head_dim"]
        dim = a["heads"] * a["head_dim"]
        nbytes = 4 * (4 * a["windows"] * a["tokens"] * dim + (2 * a["w"] - 1) ** 2 * a["heads"])
        total += max(ops / FLOPS["float32"], nbytes / BYTES_PER_S)
    return total
