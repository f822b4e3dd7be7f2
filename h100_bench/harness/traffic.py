"""The one traffic generator: a mix file's parameters and `--seed` give
the run's requests.

A mix (`h100_bench/traffic/<name>.json`) holds:

* `kind`: "generate" (text to video, closed loop, one client);
* `requests`: how many distinct requests the run holds ready; the window
  takes them in order and starts over when it runs out;
* `prompt_words`: the words of every prompt, drawn from `vocabulary`
  (a word list beside the mix files); every prompt has the same count, so
  that every seed offers the same work;
* `request`: the fields every request carries (sizes, steps, guidance);
* `pipeline`: the serving options the program is configured with.

Every request gets its own seed for its initial noise, drawn from `--seed`.
"""

from __future__ import annotations

from typing import List

import numpy as np

from harness.manifest import BENCH


def vocabulary(name: str) -> List[str]:
    words = (BENCH / "traffic" / name).read_text().split()
    if not words:
        raise ValueError(f"empty vocabulary {name}")
    return words


def generate(mix: dict, seed: int) -> List[dict]:
    """The run's requests, the same for the same mix and seed."""
    if mix["kind"] != "generate":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    rng = np.random.default_rng([int(seed), 1])
    words = vocabulary(mix["vocabulary"])
    out = []
    for _ in range(int(mix["requests"])):
        picks = rng.integers(0, len(words), int(mix["prompt_words"]))
        out.append(dict(mix["request"],
                        prompt=" ".join(words[i] for i in picks),
                        seed=int(rng.integers(0, 2**31 - 1))))
    return out
