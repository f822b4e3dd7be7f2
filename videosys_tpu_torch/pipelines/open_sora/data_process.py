"""Resolution / aspect-ratio / frame-count resolution for Open-Sora.

The numeric bucket tables are extracted verbatim (as data) from the
reference's `videosys/pipelines/open_sora/data_process.py:39-497` into
`resolution_data.json` — they are model constants required for output parity,
like checkpoint hyperparameters.
"""

from __future__ import annotations

import json
import pathlib
import re

_DATA = json.loads(
    (pathlib.Path(__file__).parent / "resolution_data.json").read_text()
)
ASPECT_RATIO_MAP: dict = _DATA["ASPECT_RATIO_MAP"]
NUM_FRAMES_MAP: dict = _DATA["NUM_FRAMES_MAP"]
RESOLUTIONS: dict = _DATA["RESOLUTIONS"]


def get_image_size(resolution: str, aspect_ratio: str) -> tuple[int, int]:
    """(height, width) for a named resolution/AR bucket (data_process.py:474-478)."""
    ar_key = ASPECT_RATIO_MAP[aspect_ratio]
    table = RESOLUTIONS[resolution]["table"]
    if ar_key not in table:
        raise ValueError(f"aspect ratio {aspect_ratio} not found for {resolution}")
    h, w = table[ar_key]
    return int(h), int(w)


def get_num_frames(num_frames) -> int:
    """'2s'/'4x' style names or raw ints (data_process.py:495-498)."""
    if isinstance(num_frames, str) and num_frames in NUM_FRAMES_MAP:
        return int(NUM_FRAMES_MAP[num_frames])
    return int(num_frames)


_WHITESPACE_RE = re.compile(r"\s+")

# Punctuation runs scrubbed to a space (reference BAD_PUNCT_REGEX,
# pipeline_open_sora.py:25-27 — originally the DeepFloyd/PixArt caption
# cleaner; the patterns are behavioral constants required for T5-input
# parity with the trained model).
_BAD_PUNCT = re.compile(r"[#®•©™&@·º½¾¿¡§~\)\(\]\[\}\{\|\\/\*]{1,}")

# The ordered regex battery of _clean_caption (pipeline_open_sora.py:309-415).
# Each entry is (compiled pattern, replacement); table-driven rather than a
# statement per rule, but the patterns and their order are the behavior.
_URL1 = r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))"
_URL2 = r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))"
_PRE_HTML_RULES = [(re.compile(p), r) for p, r in [
    (r"<person>", "person"),
    (_URL1, ""),
    (_URL2, ""),
]]
_POST_HTML_RULES = [(re.compile(p), r) for p, r in [
    (r"@[\w\d]+\b", ""),                 # @nicknames
    # CJK / Yijing / Katakana-extension codepoint ranges
    (r"[\u31c0-\u31ef]+", ""), (r"[\u31f0-\u31ff]+", ""),
    (r"[\u3200-\u32ff]+", ""), (r"[\u3300-\u33ff]+", ""),
    (r"[\u3400-\u4dbf]+", ""), (r"[\u4dc0-\u4dff]+", ""),
    (r"[\u4e00-\u9fff]+", ""),
    # unify dashes / quotes
    (r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B"
     r"\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+", "-"),
    (r"[`´«»“”¨]", '"'),
    (r"[‘’]", "'"),
    (r"&quot;?", ""), (r"&amp", ""),
    (r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " "),   # IP addresses
    (r"\d:\d\d\s+$", ""),                           # article ids
    (r"\\n", " "),
    (r"#\d{1,3}\b", ""), (r"#\d{5,}\b", ""), (r"\b\d{6,}\b", ""),
    (r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", ""),  # filenames
    (r"[\"\']{2,}", '"'), (r"[\.]{2,}", " "),
]]
_TAIL_RULES = [(re.compile(p), r) for p, r in [
    (r"\b[a-zA-Z]{1,3}\d{3,15}\b", ""),             # jc6640
    (r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", ""),             # jc6640vc
    (r"\b\d+[a-zA-Z]+\d+\b", ""),                   # 6640vc231
    (r"(worldwide\s+)?(free\s+)?shipping", ""),
    (r"(free\s)?download(\sfree)?", ""),
    (r"\bclick\b\s(?:for|on)\s\w+", ""),
    (r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", ""),
    (r"\bpage\s+\d+\b", ""),
    (r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", " "),   # j2d1a2a...
    (r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", ""),           # dimensions 100x200
    (r"\b\s+\:\s+", ": "),
    (r"(\D[,\./])\b", r"\1 "),
    (r"\s+", " "),
]]
_FINAL_RULES = [(re.compile(p), r) for p, r in [
    (r"^[\"\']([\w\W]+)[\"\']$", r"\1"),
    (r"^[\'\_,\-\:;]", ""),
    (r"[\'\_,\-\:\-\+]$", ""),
    (r"^\.\S+$", ""),
]]
_DASH_UNDERSCORE = re.compile(r"(?:\-|\_)")


def basic_clean(text: str) -> str:
    """ftfy + double html-unescape (reference _basic_clean :299-303).
    ftfy is optional in this image; without it mojibake survives but ASCII
    prompts are unaffected."""
    import html

    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def clean_caption(caption: str) -> str:
    """Full port of the reference `_clean_caption`
    (pipeline_open_sora.py:304-415): the exact cleaning used at training
    time, so messy prompts produce the same T5 inputs."""
    import urllib.parse as ul

    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    for pat, rep in _PRE_HTML_RULES:
        caption = pat.sub(rep, caption)
    try:
        from bs4 import BeautifulSoup

        caption = BeautifulSoup(caption, features="html.parser").text
    except ImportError:
        pass
    for pat, rep in _POST_HTML_RULES:
        caption = pat.sub(rep, caption)
    caption = _BAD_PUNCT.sub(" ", caption)
    caption = re.sub(r"\s+\.\s+", " ", caption)
    if len(_DASH_UNDERSCORE.findall(caption)) > 3:
        caption = _DASH_UNDERSCORE.sub(" ", caption)
    caption = basic_clean(caption)
    for pat, rep in _TAIL_RULES:
        caption = pat.sub(rep, caption)
    caption.strip()
    for pat, rep in _FINAL_RULES:
        caption = pat.sub(rep, caption)
    return caption.strip()


def text_preprocessing(text: str, use_text_preprocessing: bool = True) -> str:
    """The exact text cleaning as in the reference training stage
    (pipeline_open_sora.py:417-424): clean_caption applied TWICE."""
    if use_text_preprocessing:
        return clean_caption(clean_caption(text))
    return text.lower().strip()


def append_score_to_prompts(prompts, aes=None, flow=None, camera_motion=None):
    """Score-token suffixes Open-Sora was trained with (data_process.py
    equivalent of append_score_to_prompts in the reference pipeline)."""
    new_prompts = []
    for prompt in prompts:
        new_prompt = prompt
        if aes is not None and "aesthetic score:" not in prompt:
            new_prompt = f"{new_prompt} aesthetic score: {aes:.1f}."
        if flow is not None and "motion score:" not in prompt:
            new_prompt = f"{new_prompt} motion score: {flow:.1f}."
        if camera_motion is not None and "camera motion:" not in prompt:
            new_prompt = f"{new_prompt} camera motion: {camera_motion}."
        new_prompts.append(new_prompt)
    return new_prompts


def split_prompt(prompt_text: str):
    """Parse the per-loop prompt syntax ``|0| text a |1| text b`` into
    (text_list, loop_idx_list); plain prompts return ([text], None)
    (reference pipeline_open_sora.py:769-784)."""
    if prompt_text.startswith("|0|"):
        parts = prompt_text.split("|")[1:]
        text_list, loop_idx = [], []
        for i in range(0, len(parts), 2):
            loop_idx.append(int(parts[i]))
            text_list.append(parts[i + 1].strip())
        return text_list, loop_idx
    return [prompt_text], None


def merge_prompt(text_list, loop_idx_list=None) -> str:
    """Inverse of split_prompt (reference :787-794)."""
    if loop_idx_list is None:
        return text_list[0]
    return "".join(f"|{idx}|{text}"
                   for idx, text in zip(loop_idx_list, text_list))


def extract_prompts_loop(prompts, num_loop: int):
    """Per-loop prompt selection: segment k covers loops
    [start_k, start_{k+1}) (reference :753-766)."""
    ret = []
    for prompt in prompts:
        if prompt.startswith("|0|"):
            parts = prompt.split("|")[1:]
            text_list = []
            for i in range(0, len(parts), 2):
                start_loop = int(parts[i])
                text = parts[i + 1]
                end_loop = (int(parts[i + 2]) if i + 2 < len(parts)
                            else num_loop + 1)
                text_list.extend([text] * (end_loop - start_loop))
            prompt = text_list[num_loop]
        ret.append(prompt)
    return ret


def refine_prompt(prompt: str, model: str = "gpt-4o",
                  example_path: str = None) -> str:
    """Optional OpenAI prompt refinement (pipeline_open_sora.py:897-959).
    Needs the `openai` package and OPENAI_API_KEY; raises a clear error when
    unavailable (offline images) instead of failing mid-generate."""
    try:
        from openai import OpenAI
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "Prompt refinement needs the `openai` package and an API key; "
            "pass the raw prompt or install openai.") from e
    sys_prompt = (
        "You need to refine user's input prompt. The user's input prompt is "
        "used for video generation task. You need to refine the user's "
        "prompt to make it more suitable for the task. The refined prompt "
        "should pay attention to all objects in the video. The description "
        "should be useful for AI to re-generate the video. The description "
        "should be no more than six sentences. The refined prompt should be "
        "in English.")
    client = OpenAI()
    out = client.chat.completions.create(
        model=model,
        messages=[{"role": "system", "content": sys_prompt},
                  {"role": "user", "content": prompt}],
        temperature=0.01, max_tokens=250)
    return out.choices[0].message.content


def add_watermark(video_path: str, watermark_path: str,
                  output_path: str = None) -> str:
    """Watermark overlay (pipeline_open_sora.py:962-972 shells out to
    ffmpeg). Uses the ffmpeg binary when present; raises clearly otherwise."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:  # pragma: no cover
        raise RuntimeError("watermarking needs the ffmpeg binary on PATH")
    output_path = output_path or video_path.replace(".mp4", "_watermarked.mp4")
    cmd = ["ffmpeg", "-y", "-i", video_path, "-i", watermark_path,
           "-filter_complex", "[1][0]scale2ref=oh*mdar:ih*0.1[logo][video];"
           "[video][logo]overlay", output_path]
    subprocess.run(cmd, check=True, capture_output=True)
    return output_path
