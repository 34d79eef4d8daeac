"""One cache of packed layer weights for the port's kernel wrappers.

A kernel reads a layer's weights in its own order (`ops/fused_lstm.py`'s
`pack_bilstm`, `ops/fused_gru.py`'s `pack_bigru`). Packing is a handful of
small device kernels, so a layer is packed once and the pack reused while
its source tensors stay as they were: an entry holds those tensor objects,
so their ids and their storage cannot pass to another layer while it lives,
and it is reused only for the same objects at the same `_version` (which an
optimizer's in-place step bumps) and storage. Inference tensors track no
version, so a layer that holds one is packed on every call.

The cache holds CACHE_SIZE entries plus the room its live users reserve:
a runner or a vote function over a mesh packs every replica's layers and
reserves an entry for each while it lives (`reserve`), so no pack is
rebuilt between its batches however many such users are alive at once.
"""
import itertools
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

CACHE_SIZE = 32
# reservation number -> entries, one per live owner
_reserved: Dict[int, int] = {}
_numbers = itertools.count()
# (kind, id of each source tensor) -> (the tensors, their state, pack)
_cache: "OrderedDict[tuple, Tuple[tuple, tuple, Any]]" = OrderedDict()


def cached_pack(kind: str, tensors: Sequence[torch.Tensor],
                build: Callable[[], Any]) -> Tuple[Any, bool]:
    """(pack, built): `build()`'s pack for these source tensors, from the
    cache where an entry of this `kind` still matches them; built says
    whether `build` ran."""
    tensors = tuple(tensors)
    if any(t.is_inference() for t in tensors):
        return build(), True
    key = (kind,) + tuple(id(t) for t in tensors)
    state = tuple((t._version, t.data_ptr()) for t in tensors)
    hit = _cache.get(key)
    if hit is not None and hit[1] == state \
            and all(a is b for a, b in zip(hit[0], tensors)):
        _cache.move_to_end(key)
        return hit[2], False
    pack = build()
    _cache[key] = (tensors, state, pack)
    _cache.move_to_end(key)
    while len(_cache) > capacity():
        _cache.popitem(last=False)
    return pack, True


def capacity() -> int:
    """CACHE_SIZE plus every live owner's reservation."""
    return CACHE_SIZE + sum(_reserved.values())


def reserve(owner: object, entries: int) -> None:
    """Keep room for `entries` packs beyond CACHE_SIZE while `owner` lives;
    the reservations of live owners add up."""
    number = next(_numbers)
    _reserved[number] = entries
    weakref.finalize(owner, _reserved.pop, number, None)
