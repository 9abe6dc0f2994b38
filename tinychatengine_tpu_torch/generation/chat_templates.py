"""Per-family chat templates + stop conditions (counterpart of the JAX
package's ``generation/chat_templates.py``).

Behavioral parity with the reference REPL's prompt wrapping
(llm/application/chat.cc:291,295,421-441,484-504,651-717,1095-1154): each
family has a first-turn wrap (with system preamble) and a follow-up wrap,
plus stop strings/tokens (LLaMA3Generate.cc:183-195 stop ids; "### Human"
string checks in the drivers).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    first: str          # format with {input}
    next: str           # format with {input}
    stop_strings: tuple = ()
    stop_token_names: tuple = ()  # resolved against the tokenizer


_VICUNA_SYS = ('A chat between a curious human ("Human") and an artificial '
               'intelligence assistant ("Assistant"). The assistant gives '
               "helpful, detailed, and polite answers to the human's questions.")

TEMPLATES: dict[str, ChatTemplate] = {
    # LLaMA-2 chat (chat.cc:437,441)
    "llama2": ChatTemplate(
        first=_VICUNA_SYS + "\n\n### Human: {input}\n### Assistant: ",
        next="### Human: {input}\n### Assistant: \n",
        stop_strings=("### Human",),
    ),
    # LLaMA-3 (chat.cc:291,295 — plain Human/Assistant preamble; stop ids
    # handled by token names below)
    "llama3": ChatTemplate(
        first=_VICUNA_SYS.replace("helpful, detailed", "detailed, helpful")
        + "\n\nHuman: {input}\nAssistant: ",
        next="Human: {input}\nAssistant: \n",
        stop_strings=("Human:",),
        stop_token_names=("<|end_of_text|>", "<|eot_id|>", "<|begin_of_text|>"),
    ),
    # CodeLlama / Mistral instruct (chat.cc:421,425)
    "instruct": ChatTemplate(
        first="<s>[INST] {input} [/INST] ",
        next=" </s> <s>[INST] {input} [/INST] ",
    ),
    # LLaVA / VILA (chat.cc:651-659; image goes before the first input)
    "vlm": ChatTemplate(
        first="This is a chat between a user and an assistant.\n\n### USER: "
              "{image}\n{input}\n### ASSISTANT:",
        next="### USER: {input}\n### ASSISTANT: \n",
        stop_strings=("### USER",),
    ),
    # StarCoder: raw completion, no wrap (GPTBigCodeGenerate.cc)
    "completion": ChatTemplate(first="{input}", next="{input}"),
}


def template_for(model_name: str) -> ChatTemplate:
    n = model_name.lower()
    if "llama3" in n or "llama_3" in n:
        return TEMPLATES["llama3"]
    if "codellama" in n or "mistral" in n:
        return TEMPLATES["instruct"]
    if "llava" in n or "vila" in n:
        return TEMPLATES["vlm"]
    if "starcoder" in n:
        return TEMPLATES["completion"]
    if "opt" in n:
        return TEMPLATES["completion"]
    if "bytellama" in n:  # in-repo accuracy model: raw code completion
        return TEMPLATES["completion"]
    return TEMPLATES["llama2"]
