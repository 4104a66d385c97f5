"""Conversation templates and prompt rendering (the port's own copy of
``llava_plus_tpu/conversation.py``).

Parity target: reference ``llava/conversation.py`` (the 13 registered
templates, 5 separator styles, and the LLaVA-Plus tool-output grammar).
Prompt strings must match the reference byte-for-byte because trained
checkpoints are conditioned on them.

Design differences from the reference: rendering is a dispatch table of pure
functions per separator style instead of one long if/elif chain, and the
tool-output grammar uses ``json.loads`` (never ``eval`` — the reference's
``conversation.py:296`` eval-on-model-output is a known bug we fix).
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
import os
import re
from io import BytesIO
from typing import Any, Dict, List, Optional, Tuple, Union

from PIL import Image


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


# ---------------------------------------------------------------------------
# LLaVA-Plus tool-output grammar
# ---------------------------------------------------------------------------

TOOL_OUTPUT_PATTERN = re.compile(
    r'"thoughts🤔"(.*)"actions🚀"(.*)"value👉"(.*)', re.DOTALL
)


def parse_tool_output(text: str):
    """Parse a model response into (thoughts, actions, value) groups.

    Returns the single-match list (same shape as the reference's
    ``re.findall`` result, ``conversation.py:10-20``) or ``None`` when the
    text does not contain exactly one well-formed tool block.
    """
    matches = TOOL_OUTPUT_PATTERN.findall(text)
    if len(matches) != 1 or len(matches[0]) != 3:
        return None
    return matches


def serialize_tool_turn(
    thoughts: Optional[str] = None,
    actions: Optional[Any] = None,
    value: Optional[str] = None,
) -> str:
    """Inverse of :func:`parse_tool_output`: render the emoji grammar used in
    training data (reference ``llava/mm_utils.py:117-149``). Byte-exact."""
    out = ""
    if thoughts is not None:
        out += '"thoughts🤔" {}'.format(thoughts) + "\n"
    if actions is not None:
        out += '"actions🚀" {}'.format(json.dumps(actions)) + "\n"
    if value is not None:
        out += '"value👉" {}'.format(value) + "\n"
    return out


def parse_actions(actions_text: str):
    """Parse the actions JSON emitted by the model. Safe: json.loads only."""
    return json.loads(actions_text.strip())


# ---------------------------------------------------------------------------
# Message helpers
# ---------------------------------------------------------------------------

def _split_message(msg):
    """A rich (multimodal) message is a tuple
    ``(text, image, image_process_mode[, sketch_mask])``. Returns the
    4-tuple with sketch_mask defaulting to None (ref conversation.py:43-48)."""
    if len(msg) == 3:
        return msg[0], msg[1], msg[2], None
    if len(msg) == 4:
        return msg[0], msg[1], msg[2], msg[3]
    raise ValueError(f"Invalid message tuple of length {len(msg)}: {msg!r}")


def _message_text(message) -> str:
    if isinstance(message, tuple):
        return _split_message(message)[0]
    return message


def expand2square_rgb(img: Image.Image, background=(122, 116, 104)) -> Image.Image:
    """Pad a PIL image to square with a solid background color."""
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    canvas = Image.new(img.mode, (side, side), background)
    canvas.paste(img, ((side - w) // 2, (side - h) // 2))
    return canvas


# ---------------------------------------------------------------------------
# Per-style prompt renderers (pure functions: (conv, messages) -> str)
# ---------------------------------------------------------------------------

def _render_single(conv: "Conversation", messages) -> str:
    out = conv.system + conv.sep
    for role, message in messages:
        if message:
            out += role + ": " + _message_text(message) + conv.sep
        else:
            out += role + ":"
    return out


def _render_two(conv: "Conversation", messages) -> str:
    seps = (conv.sep, conv.sep2)
    out = conv.system + seps[0]
    for i, (role, message) in enumerate(messages):
        if message:
            out += role + ": " + _message_text(message) + seps[i % 2]
        else:
            out += role + ":"
    return out


def _render_mpt(conv: "Conversation", messages) -> str:
    out = conv.system + conv.sep
    for role, message in messages:
        if message:
            out += role + _message_text(message) + conv.sep
        else:
            out += role
    return out


def _render_llama_2(conv: "Conversation", messages) -> str:
    out = ""
    for i, (role, message) in enumerate(messages):
        if i == 0:
            assert message, "first message should not be none"
            assert role == conv.roles[0], "first message should come from user"
        if not message:
            continue
        text = _message_text(message)
        if i == 0:
            text = f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n" + text
        if i % 2 == 0:
            out += conv.sep + f"[INST] {text} [/INST]"
        else:
            out += " " + text + " " + conv.sep2
    return out.lstrip(conv.sep)


def _render_plain(conv: "Conversation", messages) -> str:
    seps = (conv.sep, conv.sep2)
    out = conv.system
    for i, (_role, message) in enumerate(messages):
        if message:
            out += _message_text(message) + seps[i % 2]
    return out


_RENDERERS = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.LLAMA_2: _render_llama_2,
    SeparatorStyle.PLAIN: _render_plain,
}


# ---------------------------------------------------------------------------
# Conversation state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Conversation:
    """Conversation history + rendering rules (ref conversation.py:60-482)."""

    system: str
    roles: Tuple[str, ...]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        messages = self.messages
        # When the first message carries an image, rewrite it so the <image>
        # token sits in the canonical position (ref conversation.py:76-88).
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in self.messages]
            init_role, init_msg_tuple = messages[0]
            init_text = init_msg_tuple[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, init_text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, "<image>\n" + init_text]
        try:
            renderer = _RENDERERS[self.sep_style]
        except KeyError:
            raise ValueError(f"Invalid style: {self.sep_style}")
        return renderer(self, messages)

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    # -- image extraction ---------------------------------------------------

    def _iter_user_image_messages(self):
        for role, msg in self.messages[self.offset:]:
            if len(self.roles) > 2 and role == self.roles[2]:
                continue
            if role == self.roles[0] and isinstance(msg, tuple):
                yield _split_message(msg)

    @staticmethod
    def _encode(img: Image.Image, return_pil: bool):
        if return_pil:
            return img
        buf = BytesIO()
        img.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def get_images(self, return_pil: bool = False):
        """Extract user images with their per-message process mode applied
        and the reference's 400/800px bounding resize
        (ref conversation.py:156-218)."""
        images = []
        for _text, image, mode, _mask in self._iter_user_image_messages():
            if mode == "Pad":
                image = expand2square_rgb(image)
            elif mode in ("Default", "Crop", "None"):
                pass
            elif mode == "Resize":
                image = image.resize((336, 336))
            else:
                raise ValueError(f"Invalid image_process_mode: {mode}")
            max_hw, min_hw = max(image.size), min(image.size)
            aspect_ratio = max_hw / min_hw
            max_len, min_len = 800, 400
            shortest_edge = int(min(max_len / aspect_ratio, min_len, min_hw))
            longest_edge = int(shortest_edge * aspect_ratio)
            W, H = image.size
            if longest_edge != max(image.size):
                if H > W:
                    H, W = longest_edge, shortest_edge
                else:
                    H, W = shortest_edge, longest_edge
                image = image.resize((W, H))
            images.append(self._encode(image, return_pil))
        return images

    def get_raw_images(self, return_pil: bool = False):
        """Extract user images resized to fit in 800px (ref :220-253)."""
        images = []
        for _text, img, _mode, _mask in self._iter_user_image_messages():
            w, h = img.size
            if max(h, w) > 800:
                if h > w:
                    new_h, new_w = 800, int(w * 800 / h)
                else:
                    new_w, new_h = 800, int(h * 800 / w)
                img = img.resize((new_w, new_h))
            images.append(self._encode(img, return_pil))
        return images

    # -- chat-transcript rendering ------------------------------------------

    def to_chatbot(self):
        """Render as [[user, assistant], ...] pairs for web UIs
        (ref ``to_gradio_chatbot``, conversation.py:373-410). Images become an
        inline base64 <img> tag."""
        rows = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if len(self.roles) > 2 and role == self.roles[2]:
                continue
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text = _split_message(msg)[0]
                    rows.append([text.replace("<image>", "").strip(), None])
                else:
                    rows.append([msg, None])
            else:
                if rows:
                    rows[-1][1] = _message_text(msg) if msg else None
        return rows

    # -- plumbing -----------------------------------------------------------

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=tuple(self.roles),
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> Dict[str, Any]:
        if self.get_images():
            messages = [
                [r, m[0] if isinstance(m, tuple) else m]
                for r, m in self.messages
            ]
        else:
            messages = [[r, m] for r, m in self.messages]
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


# ---------------------------------------------------------------------------
# Registered templates (ref conversation.py:485-646)
# ---------------------------------------------------------------------------

conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        ["Assistant",
            "Renewable energy sources are those that can be replenished naturally in a relatively "
            "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
            "Non-renewable energy sources, on the other hand, are finite and will eventually be "
            "depleted, such as coal, oil, and natural gas. Here are some key differences between "
            "renewable and non-renewable energy sources:\n"
            "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
            "energy sources are finite and will eventually run out.\n"
            "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
            "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
            "and other negative effects.\n"
            "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
            "have lower operational costs than non-renewable sources.\n"
            "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
            "locations than non-renewable sources.\n"
            "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
            "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
            "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
            "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_templates: Dict[str, Conversation] = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,

    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,

    "mpt": conv_mpt,
}

# Default template is env-overridable (ref conversation.py:624-627).
_default_name = os.getenv("LLAVA_DEFAULT_CONVERSATION", "conv_vicuna_v1")
default_conversation = globals().get(_default_name, conv_vicuna_v1)
