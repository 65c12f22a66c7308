"""The CRX2 container's layout and the K9/K10 wrappers' CPU route.

``container_layout`` (the offsets and the largest size that K9's wrapper
allocates) and ``escape_terminators`` (the count ``LaneCoder._upload``
holds to n_esc before K10 runs, where the host's decoder would raise) are
held to the host's reference, ``assemble_container`` and
``container_arrays``: at the layout's edges (one lane, no words, odd word
counts, no escapes), at every varint length with int32's ends, sorted
with either verdict, and on fuzzed escape regions. On the CPU the wrappers
of K9 (``container_write``) and K10 (``container_read``) run that
reference in the kernels' framing. The malformed streams
``tests/_crx2_cases.py`` lists raise the same ValueError here as on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from _crx2_cases import (LAYOUT_CASES, VARINT_EDGES, arrays, escape_region, malformed_streams,
                         reference_arrays, valid_stream, with_region)
from cra5_tpu_torch.coder import rans_kernels as rk
from cra5_tpu_torch.coder.lane_coder import (LaneCoder, assemble_container, escape_terminators,
                                             parse_v2_header, zigzag_varint_encode)
from cra5_tpu_torch.entropy import gc_update, get_scale_table

CASE_IDS = [c[0] for c in LAYOUT_CASES]


@pytest.fixture(scope="module")
def gc_table():
    return gc_update(get_scale_table())


def _packed(case, seed=0):
    """(host arrays, the reference container) of a layout case."""
    _, K, nw, ne, srt, safe, kind = case
    states, words, escs = arrays(np.random.default_rng(seed), K, nw, ne, kind)
    data = assemble_container(3 * K + ne, K, nw, ne, srt, safe, states, words, escs)
    return (K, nw, ne, srt, safe, states, words, escs), data


def _write_cpu(K, nw, ne, srt, safe, states, words, escs):
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).view(dt))
    return rk.container_write(3 * K + ne, srt, t(states, np.int32), t(words, np.int16),
                              t(escs, np.int32), torch.tensor(safe))


def test_varint_edges_take_every_length():
    lengths = [len(zigzag_varint_encode(np.array([v], np.int32))) for v in VARINT_EDGES]
    assert lengths == [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4
    assert {int(VARINT_EDGES.min()), int(VARINT_EDGES.max())} == {-(1 << 31), (1 << 31) - 1}


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=CASE_IDS)
def test_layout_gives_the_reference_containers_offsets(case):
    (K, nw, ne, srt, safe, states, words, escs), data = _packed(case)
    at = rk.container_layout(K, nw, ne)
    assert (at.states, at.words) == (20, 20 + 4 * K)
    assert data[at.states:at.words] == states.astype("<u4").tobytes()
    assert data[at.words:at.escapes] == words.astype("<u2").tobytes()
    assert data[at.escapes:] == zigzag_varint_encode(escs)
    assert len(data) <= at.capacity
    every_longest = assemble_container(1, K, nw, ne, srt, safe, states, words,
                                       np.full(ne, -(1 << 31), np.int32))
    assert len(every_longest) == at.capacity
    assert escape_terminators(data, at.escapes) == ne
    assert escape_terminators(data + b"\x81\x05\x80", at.escapes) == ne + 1


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=CASE_IDS)
def test_cpu_container_write_frames_the_host_container(case):
    args, data = _packed(case)
    K, nw, ne = args[:3]
    out = _write_cpu(*args)
    assert out.dtype == torch.uint8 and out.numel() == 8 + rk.container_layout(K, nw, ne).capacity
    size = int(out[:8].numpy().view("<i8")[0])
    assert size == len(data) and out[8:8 + size].numpy().tobytes() == data
    assert rk.container_write.launches == 0  # the CPU runs the host's packer


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=CASE_IDS)
def test_cpu_container_read_gives_container_arrays(case):
    _, data = _packed(case, seed=1)
    n, K, ne, nw = parse_v2_header(data)[:4]
    image = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = rk.container_read(image, K, nw, ne)
    want = reference_arrays(data)
    assert [g.dtype for g in got] == [torch.int32, torch.int16, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert rk.container_read.launches == 0


@pytest.mark.parametrize("kind", ["random", "overlong", "trailing"])
@pytest.mark.parametrize("ne", [1, 7, 300])
def test_terminator_count_accepts_what_the_reference_decodes(kind, ne):
    """On fuzzed escape regions the count passes and the reference
    decodes; cut before the n_esc-th terminator, the count fails and the
    reference raises."""
    rng = np.random.default_rng(ne)
    words = rng.integers(0, 1 << 16, 11).astype(np.uint16)
    region = escape_region(rng, kind, ne)
    data = with_region(3, words, ne, region)
    at = rk.container_layout(3, 11, ne)
    assert escape_terminators(data, at.escapes) >= ne
    got = rk.container_read(torch.frombuffer(bytearray(data), dtype=torch.uint8), 3, 11, ne)
    for g, w in zip(got, reference_arrays(data)):
        np.testing.assert_array_equal(g.numpy(), w)
    last = np.flatnonzero(np.frombuffer(region, np.uint8) < 0x80)[ne - 1]
    cut = with_region(3, words, ne, region[:last])
    assert escape_terminators(cut, at.escapes) == ne - 1
    with pytest.raises(ValueError, match="truncated escape side channel"):
        reference_arrays(cut)


def test_cpu_container_read_of_too_few_terminators_raises():
    """The count ``_upload`` checks first, and the CPU route's own
    refusal, below n_esc."""
    data = with_region(2, np.arange(4, dtype=np.uint16), 3, bytes([0x85, 0x01, 0x04, 0x80]))
    assert escape_terminators(data, rk.container_layout(2, 4, 3).escapes) == 2
    with pytest.raises(ValueError, match="truncated escape side channel"):
        reference_arrays(data)
    with pytest.raises(ValueError, match="truncated escape side channel"):
        rk.container_read(torch.frombuffer(bytearray(data), dtype=torch.uint8), 2, 4, 3)


def test_container_wrappers_check_their_operands():
    s, w, e, f = (torch.zeros(4, dtype=torch.int32), torch.zeros(3, dtype=torch.int16),
                  torch.zeros(2, dtype=torch.int32), torch.tensor(False))
    with pytest.raises(TypeError, match="words"):
        rk.container_write(8, False, s, w.to(torch.int32), e, f)
    with pytest.raises(TypeError, match="safe"):
        rk.container_write(8, False, s, w, e, f.reshape(1))
    with pytest.raises(ValueError, match="contiguous"):
        rk.container_write(8, False, torch.zeros(8, dtype=torch.int32)[::2], w, e, f)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.container_write(8, False, s.to("meta"), w.to("meta"), e.to("meta"), f.to("meta"))
    image = _write_cpu(4, 3, 2, False, False, s.numpy().view(np.uint32),
                         w.numpy().view(np.uint16), e.numpy())[8:]
    with pytest.raises(ValueError, match="holds no container"):
        rk.container_read(image[:20 + 16 + 5], 4, 3, 2)
    with pytest.raises(TypeError, match="image"):
        rk.container_read(image.to(torch.int16), 4, 3, 2)


@pytest.mark.parametrize("which", range(11))
def test_malformed_streams_raise_on_the_cpu(gc_table, which):
    data = valid_stream(gc_table, np.random.default_rng(5), "cpu")
    name, bad, n, pattern = malformed_streams(data)[which]
    coder = LaneCoder(gc_table, num_lanes=64, device="cpu")
    with pytest.raises(ValueError, match=pattern):
        coder.upload_batch([bad], n)
