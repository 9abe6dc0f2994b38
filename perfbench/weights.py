"""Random weights made on the device from the run's seed, tensor by tensor.

Every tensor (one layer of one linear, a table, a norm) has a generator of
its own, seeded from (seed, name, layer), so the set-up and the reference
each make exactly the tensors they need and make the same ones. The
linears' names and shapes are the family's (``Model.shape``); ``layer`` is
any key that tells a family's tensors of one name apart, such as
(layer, expert).

An int4 linear is made as it is stored, in the port's checkpoint layout
(QM_TPU: ``packed [K/2, N]`` uint8, K-major, nibbles paired along K in
superblocks of 256 rows: byte row i of superblock s holds row 256 s + i in
its low nibble and row 256 s + 128 + i in its high nibble; scales
``[K/G, N]`` bf16; weight = (code - 8) * scale). The codes are centred:
uniform over 1..15, so 8, which dequantizes to 0, is the mean. The scales
are (0.5 + u) * std / 4.32 with u uniform on [0, 1), so the weights'
RMS is about ``std``: small enough that a 32- or 40-layer random model
stays well conditioned and a fault in it shows. ``codes`` unpacks the same
bytes for the reference (the layout's frozen arithmetic).
"""

from __future__ import annotations

import hashlib

import torch

from perfbench.model import Model

PLANE = 128           # byte rows per nibble plane
SUPERBLOCK = 2 * PLANE
CODE_STD = 4.32       # std of a code uniform over 1..15 about 8


def unpack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Nibble planes [K/2, N] -> codes [K, N] in K order."""
    k2, n = lo.shape
    nsb = 2 * k2 // SUPERBLOCK
    return torch.stack([lo.view(nsb, PLANE, n), hi.view(nsb, PLANE, n)],
                       dim=1).reshape(2 * k2, n)


def subseed(seed: int, name: str, layer) -> int:
    h = hashlib.blake2b(f"{int(seed)}/{name}/{layer}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Weights:
    """The seed's tensors of ``model`` on ``device``."""

    def __init__(self, model: Model, seed: int, device):
        self.model, self.seed = model, int(seed)
        self.device = torch.device(device)

    def _gen(self, name: str, layer=None) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(subseed(self.seed, name, layer))
        return g

    def planes(self, name: str, layer=None):
        """The low and high nibble planes [K/2, N] uint8 and the scales
        [K/G, N] bf16 of one linear (one layer of it)."""
        k, n, _ = self.model.shape(name)
        if k % SUPERBLOCK or k % self.model.group:
            raise ValueError(f"{name}: K = {k} is not a whole number of "
                             f"superblocks and groups")
        g = self._gen(name, layer)
        kw = dict(dtype=torch.uint8, device=self.device, generator=g)
        lo = torch.randint(1, 16, (k // 2, n), **kw)
        hi = torch.randint(1, 16, (k // 2, n), **kw)
        u = torch.rand((k // self.model.group, n), device=self.device,
                       generator=g)
        scales = ((u + 0.5) * (self.model.weight_std / CODE_STD)).to(
            torch.bfloat16)
        return lo, hi, scales

    def packed(self, name: str, layer=None, out=None, out_scales=None):
        """(packed [K/2, N] uint8, scales [K/G, N] bf16), written into
        ``out`` / ``out_scales`` when given."""
        lo, hi, scales = self.planes(name, layer)
        packed = torch.bitwise_or(lo, hi << 4, out=out)
        if out_scales is not None:
            out_scales.copy_(scales)
            scales = out_scales
        return packed, scales

    def codes(self, name: str, layer=None) -> torch.Tensor:
        """The codes [K, N] uint8 in 0..15, K in natural order."""
        lo, hi, _ = self.planes(name, layer)
        return unpack(lo, hi)

    def dense(self, name: str, layer=None) -> torch.Tensor:
        """The dequantized weight [K, N] f32: (code - 8) * scale."""
        lo, hi, scales = self.planes(name, layer)
        w = unpack(lo, hi).float() - 8.0
        del lo, hi
        k, n = w.shape
        g = self.model.group
        return (w.view(k // g, g, n) * scales.float()[:, None, :]).view(k, n)

    def bias(self, name: str) -> torch.Tensor:
        """[L, N] f32 bias of a layer linear."""
        _, n, _ = self.model.shape(name)
        return torch.randn((self.model.layers, n), device=self.device,
                           generator=self._gen(name + "/bias")) \
            * self.model.bias_std

    def norm(self, name: str, stacked: bool = True) -> torch.Tensor:
        """A norm's weight: 1 + norm_std * N(0, 1), bf16, [L, E] or [E]."""
        shape = ((self.model.layers,) if stacked else ()) + (self.model.hidden,)
        w = 1.0 + torch.randn(shape, device=self.device,
                              generator=self._gen(name)) * self.model.norm_std
        return w.to(torch.bfloat16)

    def norm_bias(self, name: str, stacked: bool = True) -> torch.Tensor:
        """A LayerNorm's bias: norm_std * N(0, 1), bf16."""
        shape = ((self.model.layers,) if stacked else ()) + (self.model.hidden,)
        return (torch.randn(shape, device=self.device,
                            generator=self._gen(name))
                * self.model.norm_std).to(torch.bfloat16)

    def table(self, name: str, rows: int) -> torch.Tensor:
        """An embedding table [rows, E] bf16, N(0, embed_std)."""
        return (torch.randn((rows, self.model.hidden), device=self.device,
                            generator=self._gen(name))
                * self.model.embed_std).to(torch.bfloat16)
