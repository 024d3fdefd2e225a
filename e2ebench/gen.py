"""The one traffic generator: it reads a mix's data file
(``traffic/<name>.json``) and the run's seed, and yields the inputs the
adapter hands the system. Nothing here imports the system under test.

Two kinds of mix exist, one for each ``adapter`` a file names:

- chat sessions (``serving_engine``): closed-loop clients, each running
  one conversation at a time and sending the next turn as soon as the last
  is answered. A conversation starts from the shared system prompt; every
  turn appends user text to the history and asks for some new tokens; the
  answer the system serves joins the history. A conversation ends after
  ``max_turns`` turns, or before a turn would take its context past
  ``max_context``; the client then starts a new one.
- batch decode (``paged_decoder``): ``batch`` sequences of
  ``prompt_tokens`` seeded ids, decoded together.

Sizes come from a fixed pool of quantiles of the stated lognormal that
every seed shares; the seed draws the order in which each client takes
them, and the token ids (and the weights). So every seed sends the same
set of sizes in another order, and the spread between seeds is the
system's, not the mix's.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

POOL = 256  # sizes in a client's pool


def quantile_pool(spec: dict, n: int = POOL) -> list[int]:
    """``n`` sizes at the mid-quantiles of a lognormal with the spec's
    ``median`` and ``sigma``, rounded and clipped to ``[min, max]``."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = round(spec["median"] * math.exp(spec["sigma"] * z))
        out.append(int(min(max(v, spec["min"]), spec["max"])))
    return out


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole seed, negative or
    past 64 bits, is taken as its digits."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *stream])


class ChatClient:
    """One closed-loop client: the next request's prompt and size, and
    the conversation's history as the system answered it."""

    def __init__(self, mix: dict, seed: int, index: int, system: list[int],
                 vocab: int):
        self.mix = mix
        self.index = index
        self.system = system
        self.vocab = vocab
        self._rng = _rng(seed, 1, index)
        order = _rng(seed, 2, index)  # the seed's order of the pool
        self._users = [quantile_pool(mix["user_tokens"])[i]
                       for i in order.permutation(POOL)]
        self._news = [quantile_pool(mix["new_tokens"])[i]
                      for i in order.permutation(POOL)]
        self._drawn = 0
        self.conversation = -1
        self.turn = 0
        self.history: list[int] = []
        self._start()

    def _start(self) -> None:
        self.conversation += 1
        self.turn = 0
        self.history = list(self.system)

    def next_request(self) -> tuple[str, list[int], int]:
        """(request id, prompt ids, new tokens asked) of the next turn."""
        k = self._drawn % POOL
        self._drawn += 1
        user, new = self._users[k], self._news[k]
        if (self.turn >= self.mix["max_turns"]
                or len(self.history) + user + new > self.mix["max_context"]):
            self._start()
        ids = self._rng.integers(1, self.vocab, user).tolist()
        self.history = self.history + ids
        self.turn += 1
        rid = f"c{self.index}.v{self.conversation}.t{self.turn}.n{self._drawn}"
        return rid, list(self.history), new

    def answered(self, tokens: list[int]) -> None:
        """The served answer joins the history."""
        self.history = self.history + [int(t) for t in tokens]


def chat_clients(mix: dict, seed: int, vocab: int) -> list[ChatClient]:
    system = _rng(seed, 0).integers(1, vocab, mix["system_tokens"]).tolist()
    return [ChatClient(mix, seed, i, system, vocab)
            for i in range(mix["clients"])]


def batch_prompts(mix: dict, seed: int, vocab: int) -> np.ndarray:
    """(batch, prompt_tokens) seeded ids."""
    return _rng(seed, 3).integers(1, vocab, (mix["batch"],
                                             mix["prompt_tokens"]))
