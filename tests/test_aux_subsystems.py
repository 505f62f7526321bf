"""Auxiliary subsystems (SURVEY.md section 5): tracing, sanitizers, fault
injection / recovery, checkpoint-resume, reports, config layers."""

import json
import logging

import numpy as np
import pytest

from wvpk import api, config, consts, debug, trace
from wvpk.report import build_report
from wvpk.testgen import EncodeSpec, encode_file
from wvpk.testgen import faults


def stereo_file(n=1200, block=300, seed=0, **kw):
    pcm = np.round(np.random.default_rng(seed).normal(0, 2500, (n, 2))
                   ).astype(np.int64)
    return pcm, encode_file(pcm, EncodeSpec(block_samples=block, joint=True,
                                            **kw))


# --- 5.1 tracing -----------------------------------------------------------

def test_stage_trace_collects():
    pcm, data = stereo_file(seed=1)
    wpc = api.WavpackOpenFileInput(data)
    buf = np.zeros(1200 * 2, np.int32)
    # per-stage timings come from the synced stage-wise path
    config.set_options(sync_stages=True)
    try:
        with trace.collect() as stages:
            assert api.WavpackUnpackSamples(wpc, buf, 1200) == 1200
    finally:
        config.set_options(sync_stages=False)
    assert "entropy" in stages and "decorr" in stages
    report = trace.format_report(stages, 1200)
    assert "entropy" in report and "throughput" in report


# --- 5.2 sanitizers --------------------------------------------------------

def test_checkify_smoke():
    out = debug.checkify_smoke()
    assert out.shape == (32, 4, 2)


def test_oracle_checked_decode():
    from wvpk.container import parse_blocks
    pcm, data = stereo_file(seed=2)
    states = [b.state for b in parse_blocks(data)]
    res = debug.oracle_checked_decode(states)
    assert len(res) == 4


def test_oracle_check_option():
    from wvpk.container import parse_blocks
    from wvpk.engine import decode_states
    pcm, data = stereo_file(seed=3, n=600, block=300)
    config.set_options(oracle_check=True)
    try:
        decode_states([b.state for b in parse_blocks(data)])
    finally:
        config.set_options(oracle_check=False)


# --- 5.3 failure detection / recovery / fault injection --------------------

def test_fault_payload_corruption_concealed():
    pcm, data = stereo_file(seed=4)
    bad = faults.corrupt_block_payload(data, block_idx=1, nflips=6)
    wpc = api.WavpackOpenFileInput(bad)
    buf = np.zeros(1200 * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, 1200) == 1200
    # corrupted block muted or crc-flagged; the rest decodes exactly
    assert wpc.crc_errors >= 1
    out = buf.reshape(-1, 2)
    np.testing.assert_array_equal(out[:300], pcm[:300])
    np.testing.assert_array_equal(out[600:], pcm[600:])


def test_fault_header_resync_skips_block():
    pcm, data = stereo_file(seed=5)
    bad = faults.corrupt_header_magic(data, 1)
    wpc = api.WavpackOpenFileInput(bad)
    buf = np.zeros(1200 * 2, np.int32)
    got = api.WavpackUnpackSamples(wpc, buf, 1200)
    assert got == 1200
    out = buf.reshape(-1, 2)
    # destroyed block's range is gap-zero-filled; others intact
    np.testing.assert_array_equal(out[:300], pcm[:300])
    np.testing.assert_array_equal(out[300:600], 0)
    np.testing.assert_array_equal(out[600:], pcm[600:])


def test_fault_giant_block_samples_concealed():
    # a flipped high byte in the sample-count field claims 2^25+ samples;
    # the block-parallel engine must refuse to materialize that
    # (consts.MAX_BLOCK_SAMPLES) and conceal it like any corrupt header
    from wvpk.container import parse_blocks
    from wvpk.container.header import scan_headers
    pcm, data = stereo_file(seed=11)
    hdr1 = scan_headers(data)[1]
    bad = bytearray(data)
    pos = hdr1.stream_position + 23            # block_samples high byte
    bad[pos] = 0x42
    bad = bytes(bad)
    assert scan_headers(bad)[1].block_samples > consts.MAX_BLOCK_SAMPLES
    kept = parse_blocks(bad)
    assert [b.header.block_index for b in kept] == [0, 600, 900]
    with pytest.raises(ValueError, match="engine cap"):
        parse_blocks(bad, strict=True)
    # full decode conceals the range like a destroyed header
    wpc = api.WavpackOpenFileInput(bad)
    buf = np.zeros(1200 * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, 1200) == 1200
    out = buf.reshape(-1, 2)
    np.testing.assert_array_equal(out[:300], pcm[:300])
    np.testing.assert_array_equal(out[300:600], 0)
    np.testing.assert_array_equal(out[600:], pcm[600:])
    # streaming (LazyBlocks) path conceals identically
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".wv") as f:
        f.write(bad)
        f.flush()
        wpc = api.WavpackOpenFileInput(f.name, streaming=True)
        buf2 = np.zeros(1200 * 2, np.int32)
        assert api.WavpackUnpackSamples(wpc, buf2, 1200) == 1200
        np.testing.assert_array_equal(buf2, buf)


def test_fault_prepended_garbage_resync():
    pcm, data = stereo_file(seed=6, n=300, block=300)
    wpc = api.WavpackOpenFileInput(faults.prepend_garbage(data))
    buf = np.zeros(300 * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, 300) == 300
    np.testing.assert_array_equal(buf.reshape(-1, 2), pcm)


def test_fault_truncated_file():
    pcm, data = stereo_file(seed=7)
    wpc = api.WavpackOpenFileInput(faults.truncate(data, 0.6))
    buf = np.zeros(1200 * 2, np.int32)
    got = api.WavpackUnpackSamples(wpc, buf, 1200)
    # decodes the complete blocks, stops at the truncated one
    assert got % 300 == 0 and 0 < got < 1200
    np.testing.assert_array_equal(buf[:got * 2].reshape(-1, 2),
                                  pcm[:got])


# --- 5.4 checkpoint / resume ----------------------------------------------

def test_resume_at_any_block_boundary():
    pcm, data = stereo_file(seed=8)
    # a fresh context seeked to a boundary reproduces the suffix exactly:
    # every block header is a checkpoint
    wpc = api.WavpackOpenFileInput(data)
    assert api.SetSample(wpc, 600)
    buf = np.zeros(600 * 2, np.int32)
    assert api.WavpackUnpackSamples(wpc, buf, 600) == 600
    np.testing.assert_array_equal(buf.reshape(-1, 2), pcm[600:])


# --- 5.5 reports / logging --------------------------------------------------

def test_decode_report_json(caplog):
    pcm, data = stereo_file(seed=9)
    wpc = api.WavpackOpenFileInput(data)
    buf = np.zeros(1200 * 2, np.int32)
    api.WavpackUnpackSamples(wpc, buf, 1200)
    rep = build_report(wpc, file="x.wv", decode_seconds=0.5,
                       samples_decoded=1200)
    d = json.loads(rep.to_json())
    assert d["num_channels"] == 2 and d["crc_errors"] == 0
    assert d["lossless"] is True
    with caplog.at_level(logging.INFO, logger="wvpk"):
        rep.emit()
    assert "decode report" in caplog.text


# --- 5.6 config layers -------------------------------------------------------

def test_options_roundtrip():
    config.set_options(batch_blocks=8)
    try:
        assert config.get_options().batch_blocks == 8
    finally:
        config.set_options(batch_blocks=256)


def test_cli_trace_and_report(tmp_path, capsys):
    from wvpk.cli import main
    pcm, data = stereo_file(seed=10, n=400, block=200)
    src = tmp_path / "t.wv"
    src.write_bytes(data)
    assert main([str(src), "--trace", "--report"]) == 0
    out = capsys.readouterr().out
    assert "stage timings" in out
    assert '"crc_errors": 0' in out
