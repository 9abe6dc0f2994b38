"""A configuration file read into the sizes the benchmark works with.

The file holds the model's published ``config.json`` keys at its top level
(Hugging Face names), ``family`` (the reference and the forward that run
it), ``quant`` (the scheme the cell serves) and ``assumed`` (what the
source does not give: the random weights' code distribution and scale).
The port's registry differences are recorded in ``registry_differs`` and
play no part here: the port is handed a ``ModelConfig`` built from these
sizes (``program.model_config``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

LMHEAD_PAD = 2048  # the llama family's int4 lm_head: N rounded up to this


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    family: str            # "llama" | "gptbigcode"
    layers: int
    hidden: int            # E
    inter: int             # F
    heads: int             # Hq
    kv_heads: int          # Hkv
    vocab: int             # V
    positions: int         # the published position count
    eps: float
    rope_theta: float = 0.0
    window: Optional[int] = None
    scheme: str = "w4a16"  # "w4a8" | "w4a16"
    group: int = 128
    weight_std: float = 0.005
    norm_std: float = 0.1
    embed_std: float = 0.02
    bias_std: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def lm_head_cols(self) -> int:
        """The int4 lm_head's stored columns (the llama family pads N)."""
        if self.family == "llama":
            return -(-self.vocab // LMHEAD_PAD) * LMHEAD_PAD
        return self.vocab

    def linears(self) -> list:
        """(name, K, N, bias) of every layer linear, in layer order."""
        e, f, d = self.hidden, self.inter, self.head_dim
        if self.family == "llama":
            return [("wqkv", e, (self.heads + 2 * self.kv_heads) * d, False),
                    ("wo", self.heads * d, e, False),
                    ("wgate_up", e, 2 * f, False),
                    ("down", f, e, False)]
        return [("c_attn", e, e + 2 * d, True), ("c_proj", e, e, True),
                ("fc_in", e, f, True), ("fc_out", f, e, True)]

    def kv_bytes_per_token(self) -> int:
        """Bytes of one position's K and V in one layer (bf16)."""
        return 2 * self.kv_heads * self.head_dim * 2


def model_from_config(name: str, c: dict) -> Model:
    """The sizes of configuration file ``c`` (published keys of the
    llama / Mistral and GPTBigCode configs)."""
    fam = c["family"]
    q, a = c["quant"], c["assumed"]
    common = dict(name=name, family=fam, scheme=q["scheme"],
                  group=q["group_size"], weight_std=a["weight_std"],
                  norm_std=a["norm_std"], embed_std=a["embed_std"],
                  bias_std=a.get("bias_std", 0.0))
    if fam == "llama":
        return Model(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                     inter=c["intermediate_size"],
                     heads=c["num_attention_heads"],
                     kv_heads=c["num_key_value_heads"],
                     vocab=c["vocab_size"],
                     positions=c["max_position_embeddings"],
                     eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
                     window=c.get("sliding_window"), **common)
    if fam == "gptbigcode":
        return Model(layers=c["n_layer"], hidden=c["n_embd"],
                     inter=c["n_inner"], heads=c["n_head"],
                     kv_heads=1 if c["multi_query"] else c["n_head"],
                     vocab=c["vocab_size"], positions=c["n_positions"],
                     eps=c["layer_norm_epsilon"], **common)
    raise ValueError(f"no reference for family {fam!r}")
