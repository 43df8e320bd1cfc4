"""What the engine is asked to compute for one request, worked out
again without the program: its prompt bucket, the bucket's token ids,
which positions hold the prompt, and how many tokens it has to emit.

A frozen copy of the rules in the port's ``serving/engine.py``
(``_bucket``, ``_shared_eff``, ``_tokenize`` and the target of
``_admit``). Without a shareable prefix: the prompt's UTF-8 bytes, cut
to the clipped prompt length, right-aligned in the bucket as ``byte %
(vocab - 1) + 1`` after zero padding. With a prefix cache and a
request of a prefix group: the group's content-hashed ids over the
first ``shared`` positions and the prompt's bytes repeated over the
rest, no padding. The oracle end of sequence at the ground-truth
length, capped by ``max_tokens`` and by the cache (``max_len - bucket -
2``).
"""

from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple


def bucket_for(prompt_tokens: int, buckets: Sequence[int]) -> int:
    n = max(int(prompt_tokens), 1)
    for b in buckets:
        if n <= b:
            return int(b)
    return int(buckets[-1])


def prompt_len(prompt_tokens: int, bucket: int) -> int:
    """Prompt tokens the engine keeps: clipped to the bucket."""
    return min(max(int(prompt_tokens), 1), int(bucket))


def shared_eff(rec, bucket: int, prefix_cache: bool) -> int:
    """The request's shareable prefix tokens in its bucket (none
    without a prefix cache)."""
    if not prefix_cache or rec.prefix_group is None:
        return 0
    return min(int(rec.shared_prefix_tokens),
               prompt_len(rec.prompt_tokens, bucket))


def prompt_ids(rec, buckets: Sequence[int], vocab: int,
               prefix_cache: bool = False) -> List[int]:
    """The ``[bucket]`` token ids the prefill runs over, for a
    ``gen.traffic.Record``."""
    bucket = bucket_for(rec.prompt_tokens, buckets)
    n = prompt_len(rec.prompt_tokens, bucket)
    v = max(vocab - 1, 1)
    shared = shared_eff(rec, bucket, prefix_cache)
    if shared:
        seed = zlib.crc32(repr(rec.prefix_group).encode())
        body = list(rec.prompt.encode() or b"\x01")
        return [(seed + p * 2654435761) % v + 1 for p in range(shared)] \
            + [body[k % len(body)] % v + 1 for k in range(bucket - shared)]
    ids = list(rec.prompt.encode()[:n * 4])[:n]
    return [0] * (bucket - len(ids)) + [b % v + 1 for b in ids]


def live_span(rec, bucket: int, prefix_cache: bool) -> Tuple[int, int]:
    """Bucket positions ``[lo, hi)`` that hold the prompt: right-aligned
    after padding, or from the start in the prefix layout."""
    n = prompt_len(rec.prompt_tokens, bucket)
    if shared_eff(rec, bucket, prefix_cache):
        return 0, n
    return bucket - n, bucket


def target(true_output_tokens: int, max_tokens: int, max_len: int,
           bucket: int) -> int:
    """Tokens the request emits, the prefill's first token included."""
    return max(1, min(int(true_output_tokens), int(max_tokens),
                      int(max_len) - int(bucket) - 2))
