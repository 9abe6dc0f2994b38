"""Tokenizers (counterpart of the JAX package's ``tokenizers``): Python
implementations of the reference's three BPE families.

- SentencePieceBPE: score-based greedy BPE (LLaMA 1/2/CodeLlama/Mistral;
  reference llm/src/LLaMATokenizer.cc, llama.cpp-derived).
- ByteLevelBPE: GPT-2 byte-level merges (OPT/StarCoder; reference
  llm/src/OPTTokenizer.cc, llm/src/GPTBigCodeTokenizer.cc).
- Llama3BPE: rank-based BPE with UTF-8 byte fallback (LLaMA-3; reference
  tokenizer embedded in llm/src/nn_modules/non_cuda/LLaMA3Generate.cc:279-477).

All three also load HuggingFace ``tokenizer.json`` when available, and the
reference's binary formats (llama_vocab.bin / vocab.json+merges.txt) for
drop-in compatibility with TinyChatEngine model zips. Their merges run in
Python (the JAX package's C++ merger is not ported yet).
"""

from tinychatengine_tpu_torch.tokenizers.bytelevel_bpe import ByteLevelBPE  # noqa: F401
from tinychatengine_tpu_torch.tokenizers.sentencepiece_bpe import SentencePieceBPE  # noqa: F401
from tinychatengine_tpu_torch.tokenizers.llama3_bpe import Llama3BPE  # noqa: F401


def get_tokenizer(family: str, path: str):
    """Tokenizer factory by model family (chat.cc model registry semantics)."""
    if family in ("llama", "llama2", "codellama", "mistral", "llava", "vila"):
        return SentencePieceBPE.load(path)
    if family in ("llama3",):
        return Llama3BPE.load(path)
    if family in ("opt", "gptbigcode", "starcoder"):
        return ByteLevelBPE.load(path)
    raise KeyError(family)
