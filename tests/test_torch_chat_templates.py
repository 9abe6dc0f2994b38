"""The port's chat templates (generation/chat_templates.py) against the JAX
package's: ``TEMPLATES`` field by field, and ``template_for`` on every
name of the model registry (CPU twins of tests/test_chat_templates.py)."""

import dataclasses

import pytest

from tinychatengine_tpu.core.config import MODEL_REGISTRY as J_REGISTRY
from tinychatengine_tpu.generation import chat_templates as jct
from tinychatengine_tpu_torch.core.config import MODEL_REGISTRY
from tinychatengine_tpu_torch.generation.chat_templates import (
    TEMPLATES, ChatTemplate, template_for)


def test_templates_equal_jax_field_by_field():
    assert list(TEMPLATES) == list(jct.TEMPLATES)
    assert [f.name for f in dataclasses.fields(ChatTemplate)] == \
        [f.name for f in dataclasses.fields(jct.ChatTemplate)]
    for name, t in TEMPLATES.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(
            jct.TEMPLATES[name]), name


@pytest.mark.parametrize("name", sorted(J_REGISTRY))
def test_template_for_every_registry_name(name):
    """Every registry name (the JAX package's registry is the port's) picks
    JAX's template; each non-CLIP model's wraps carry the input (and the
    VLMs' first wrap the image slot)."""
    assert name in MODEL_REGISTRY
    t = template_for(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(jct.template_for(name))
    if MODEL_REGISTRY[name].family == "clip":
        return
    assert "{input}" in t.first and "{input}" in t.next
    assert "hi" in t.first.replace("{image}", "").format(input="hi")
    if name in ("llava_7b", "vila_7b", "vila_13b"):
        assert "{image}" in t.first


def test_template_for_unregistered_names():
    for name in ("tiny", "demo", "demo_llava", "Meta-Llama-3-8B", "mistral_x",
                 "bytellama_5m", "OPT-125m", "StarCoder", "llama_3_tiny"):
        assert dataclasses.asdict(template_for(name)) == \
            dataclasses.asdict(jct.template_for(name)), name
