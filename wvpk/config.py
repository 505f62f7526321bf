"""Decode options (SURVEY.md section 5.6, open-level layer).

The WavPack format's other two config layers are decoded elsewhere: the
32-bit header flags bitfield drives all decode branches (consts.py,
container/blockstate.py) and CONFIG_* metadata feeds the informational
mode mask (api.get_mode). This module is the open-level layer — the
reference has only OPEN_2CH_MAX (Defines.cs:26); ours adds the batch /
layout / debug knobs the batched engine needs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DecodeOptions:
    # how many upcoming segments one lazy API decode batches together
    batch_blocks: int = 256
    # decoded-segment cache cap (insertion-order eviction); bounds API
    # memory to O(cache_segments x block) on arbitrarily long files
    cache_segments: int = 1024
    # path sources at least this many bytes open in streaming mode
    # (header index eager, payload parse lazy, bounded caches)
    stream_threshold: int = 64 << 20
    # lane capacity rounding floor (power-of-two bucketing of block sizes)
    capacity_floor: int = 256
    # synchronize the device after each pipeline stage so trace timings are
    # per-stage honest (costs pipelining; tracing only)
    sync_stages: bool = False
    # cross-check every device-decoded block against the scalar oracle
    # (slow; debugging)
    oracle_check: bool = False
    # pack the encode word scan's bit segments into dense per-lane
    # payloads ON DEVICE (ops/encode_pack.py) so only the compressed
    # bytes cross the host link, instead of fetching ~16 B of sparse
    # segment descriptors per coded value; False = fetch + host packer
    # (the C/numpy paths, kept as the byte-identity oracle)
    encode_device_pack: bool = True
    # deliver PCM from the device as packed bytes (bytes_stored+1 wide)
    # instead of int32 samples when the bucket allows it: 2-4x smaller
    # device->host transfers on the API/CLI delivery path
    packed_delivery: bool = True
    # pipeline the delivery path in chunks of this many PCM blocks:
    # chunk k+1's H2D staging + compute launch overlaps chunk k's blocking
    # payload fetch (double-buffering over PCIe). 0 = single batched
    # fetch, the default; which is faster on the H100 is not measured yet
    delivery_chunk_blocks: int = 0


_default = DecodeOptions()


def get_options() -> DecodeOptions:
    return _default


def set_options(**kwargs) -> DecodeOptions:
    global _default
    _default = replace(_default, **kwargs)
    return _default
