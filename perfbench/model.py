"""A configuration file read into the sizes the benchmark works with.

The file holds the model's published ``config.json`` keys at its top level
(Hugging Face names), ``family`` (the modules that size, build, count and
check it: ``families/<family>.py`` and ``reference/<family>.py``),
``quant`` (the scheme the cell serves) and ``assumed`` (what the source
does not give: the random weights' code distribution and scale). The
port's registry differences are recorded in ``registry_differs`` and play
no part here: the port is handed a ``ModelConfig`` built from these sizes
(``program.model_config``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from perfbench import spec


@dataclasses.dataclass(frozen=True)
class Model:
    """What every family has. A family's ``sizes`` returns a subclass that
    names its layer linears (``linears``) and adds its own fields."""

    name: str
    family: str            # families/<family>.py, reference/<family>.py
    layers: int
    hidden: int            # E
    inter: int             # F
    heads: int             # Hq
    kv_heads: int          # Hkv
    vocab: int             # V
    positions: int         # the published position count
    eps: float
    scheme: str = "w4a16"  # "w4a8" | "w4a16"
    group: int = 128
    weight_std: float = 0.005
    norm_std: float = 0.1
    embed_std: float = 0.02
    bias_std: float = 0.01
    # the benchmark directory whose families/ and reference/ hold the family
    root: Path = dataclasses.field(default=spec.HERE, compare=False,
                                   repr=False)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def lm_head_cols(self) -> int:
        """The int4 lm_head's stored columns."""
        return self.vocab

    def linears(self) -> list:
        """(name, K, N, bias) of every layer linear, in layer order."""
        raise NotImplementedError(f"family {self.family!r} names no linears")

    def shape(self, name: str) -> tuple:
        """(K, N, bias) of the int4 linear ``name`` (``Weights`` makes it;
        one tensor per layer key: a layer, or anything a family counts in
        a layer, such as (layer, expert))."""
        if name == "lm_head":
            return self.hidden, self.lm_head_cols, False
        for n, k, cols, bias in self.linears():
            if n == name:
                return k, cols, bias
        raise KeyError(name)

    def windows(self) -> list:
        """Each layer's attention window in layer order (None: full)."""
        return [None] * self.layers

    def kv_bytes_per_token(self) -> int:
        """Bytes of one position's K and V in one layer (bf16)."""
        return 2 * self.kv_heads * self.head_dim * 2


def common(name: str, c: dict) -> dict:
    """The fields of ``Model`` that every family reads alike from
    configuration file ``c``: its name, family, scheme and assumptions."""
    q, a = c["quant"], c["assumed"]
    return dict(name=name, family=c["family"], scheme=q["scheme"],
                group=q["group_size"], weight_std=a["weight_std"],
                norm_std=a["norm_std"], embed_std=a["embed_std"],
                bias_std=a.get("bias_std", 0.0))


def family(m: Model):
    """The module ``families/<m.family>.py`` of the model's root."""
    return spec.family(m.family, m.root)


def model_from_config(name: str, c: dict, root: Path = spec.HERE) -> Model:
    """The sizes of configuration file ``c`` by its family's ``sizes``
    (``families/<family>.py`` under ``root``)."""
    m = spec.family(c["family"], root).sizes(name, c)
    return dataclasses.replace(m, root=Path(root))
