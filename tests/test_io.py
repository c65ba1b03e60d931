"""I/O layer tests: BGZF/BAM roundtrip, CIGAR maps, fast5/pod5 signal,
index, and the production BamSignalSource over a synthetic dataset."""

import os

import numpy as np
import pytest

from dnascent_tpu.io import bam as bam_io
from dnascent_tpu.io import fasta as fasta_io
from dnascent_tpu.io import fast5_io, pod5_io
from dnascent_tpu.io.index_io import build_index, parse_index
from dnascent_tpu.testing.dataset import build_dataset
from dnascent_tpu.pipeline.source import BamSignalSource
from dnascent_tpu.utils.seqtools import reverse_complement


def test_bgzf_roundtrip(tmp_path):
    p = os.path.join(tmp_path, "x.bgzf")
    data = os.urandom(300000)
    w = bam_io.BGZFWriter(p)
    w.write(data)
    w.close()
    r = bam_io.BGZFReader(p)
    assert r.read(len(data)) == data
    assert r.read(10) == b""


def test_bam_record_roundtrip(tmp_path):
    seq = "ACGTTGCANNACGT"
    aux = (bam_io.encode_tag_Z("pi", "parent-read")
           + b"ns" + b"i" + (12345).to_bytes(4, "little")
           + bam_io.encode_tag_array_u8("ML", [1, 2, 250]))
    rec = bam_io.build_record("read1", 0, 100, 60,
                              [(bam_io.BAM_CSOFT_CLIP, 2),
                               (bam_io.BAM_CMATCH, 10),
                               (bam_io.BAM_CDEL, 3),
                               (bam_io.BAM_CINS, 2)],
                              seq, flag=bam_io.FLAG_REVERSE, aux=aux)
    assert rec.qname == "read1"
    assert rec.pos == 100
    assert rec.mapq == 60
    assert rec.is_reverse
    assert rec.seq() == seq
    cg = rec.cigar()
    assert cg.tolist() == [[4, 2], [0, 10], [2, 3], [1, 2]]
    assert rec.get_tag("pi") == "parent-read"
    assert rec.get_tag("ns") == 12345
    np.testing.assert_array_equal(rec.get_tag("ML"), [1, 2, 250])

    path = os.path.join(tmp_path, "t.bam")
    w = bam_io.BamWriter(path, "@HD\tVN:1.6\n", ["chr1"], [1000])
    w.write_record(rec)
    w.close()
    r = bam_io.BamReader(path)
    assert r.ref_names == ["chr1"]
    recs = list(r)
    assert len(recs) == 1
    assert recs[0].raw == rec.raw


def test_tag_replacement():
    aux = (bam_io.encode_tag_Z("MM", "N+b?,1;")
           + bam_io.encode_tag_array_u8("ML", [7])
           + bam_io.encode_tag_Z("XX", "keep"))
    rec = bam_io.build_record("r", 0, 0, 60, [(0, 4)], "ACGT", aux=aux)
    new_aux = (bam_io.encode_tag_Z("MM", "N+b?,2;N+e?,2;")
               + bam_io.encode_tag_array_u8("ML", [9, 10]))
    rec2 = rec.with_tags_replaced(["MM", "ML"], new_aux)
    assert rec2.get_tag("XX") == "keep"
    assert rec2.get_tag("MM") == "N+b?,2;N+e?,2;"
    np.testing.assert_array_equal(rec2.get_tag("ML"), [9, 10])


def test_parse_cigar_forward():
    # 2S 5M 2D 3M 1I 2M
    cg = np.array([[4, 2], [0, 5], [2, 2], [0, 3], [1, 1], [0, 2]])
    r2q, q2r, r2d, rs, re = bam_io.parse_cigar(cg, 1000, False)
    assert (rs, re) == (1000, 1012)
    # soft clip: query 0,1 -> ref 0,1 (pre-advance quirk)
    assert q2r[0] == 0 and q2r[1] == 1
    # first match block: query 2..6 -> ref 0..4
    assert q2r[2] == 0 and q2r[6] == 4
    assert r2q[0] == 2 and r2q[4] == 6
    # deletion marks ref 5,6
    assert r2d[5] and r2d[6]
    assert r2q[5] == 7 and r2q[6] == 7
    # matches resume: ref 7..9 -> query 7..9
    assert r2q[7] == 7 and r2q[9] == 9


def test_parse_cigar_reverse_mirrors_iteration_order():
    cg = np.array([[0, 5], [2, 2], [0, 3]])
    # reverse reads iterate the cigar backwards (htsInterface.cpp:68-111)
    r2q, q2r, r2d, rs, re = bam_io.parse_cigar(cg, 50, True)
    assert (rs, re) == (50, 60)
    # reversed order: 3M first
    assert r2q[0] == 0 and r2q[2] == 2
    assert r2d[3] and r2d[4]
    assert r2q[5] == 3 and r2q[9] == 7


def test_fast5_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "x.fast5")
    rng = np.random.default_rng(0)
    sig = rng.uniform(60, 120, 5000)
    fast5_io.write_fast5(path, [("read-abc", sig)])
    ids = fast5_io.fast5_extract_read_ids(path)
    assert ids == ["read-abc"]
    back = fast5_io.fast5_get_signal(path, "read-abc")
    np.testing.assert_allclose(back, sig, atol=0.1)


def test_fast5_vbz_roundtrip(tmp_path):
    """VBZ-compressed fast5 (filter 32020) reads back bit-exact WITHOUT the
    ONT HDF5 plugin (the reference only detects the filter and errors,
    src/fast5.cpp:54-66; r3 verdict missing #3)."""
    import h5py
    path = os.path.join(tmp_path, "v.fast5")
    rng = np.random.default_rng(7)
    sig = rng.uniform(60, 120, 12345)
    fast5_io.write_fast5(path, [("read-vbz", sig)], vbz=True)
    # the dataset really carries the VBZ filter, and a plugin-less plain
    # h5py read fails on it
    with h5py.File(path, "r") as fh:
        dset = fh["read_read-vbz/Raw/Signal"]
        assert fast5_io._dataset_vbz_filter(dset)
        with pytest.raises(Exception):
            dset[()]
    back = fast5_io.fast5_get_signal(path, "read-vbz")
    plain = os.path.join(tmp_path, "p.fast5")
    fast5_io.write_fast5(plain, [("read-vbz", sig)])
    np.testing.assert_array_equal(
        back, fast5_io.fast5_get_signal(plain, "read-vbz"))


def test_fast5_vbz_corrupt_chunk_raises_typed_error(tmp_path):
    import h5py
    from dnascent_tpu.utils.errors import VBZError
    path = os.path.join(tmp_path, "c.fast5")
    sig = np.linspace(60, 120, 4096)
    fast5_io.write_fast5(path, [("read-bad", sig)], vbz=True)
    with h5py.File(path, "r+") as fh:
        dset = fh["read_read-bad/Raw/Signal"]
        dset.id.write_direct_chunk((0,), b"\x10\x00\x00\x00garbage")
    with pytest.raises(VBZError):
        fast5_io.fast5_get_signal(path, "read-bad")


def test_pod5_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "x.pod5")
    rng = np.random.default_rng(1)
    sig1 = rng.uniform(60, 120, 150000)  # forces multiple signal chunks
    sig2 = rng.uniform(60, 120, 3000)
    rid1 = "11111111-2222-4333-8444-555555555555"
    rid2 = "aaaaaaaa-bbbb-4ccc-8ddd-eeeeeeeeeeee"
    pod5_io.write_pod5(path, [(rid1, sig1), (rid2, sig2)])
    ids = pod5_io.pod5_extract_read_ids(path)
    assert {i[0] for i in ids} == {rid1, rid2}
    back = pod5_io.pod5_get_signal(path, rid1)
    np.testing.assert_allclose(back, sig1, atol=0.1)
    back2 = pod5_io.pod5_get_signal(path, rid2)
    np.testing.assert_allclose(back2, sig2, atol=0.1)


def test_pod5_uncompressed_roundtrip(tmp_path, monkeypatch):
    """Uncompressed pod5 signal rows write and read back without zstd."""
    monkeypatch.setattr(pod5_io, "HAVE_ZSTD", False)
    path = os.path.join(tmp_path, "raw.pod5")
    rng = np.random.default_rng(3)
    sig = rng.uniform(60, 120, 120000)   # two signal chunks
    rid = "11111111-2222-4333-8444-666666666666"
    pod5_io.write_pod5(path, [(rid, sig)], compress=False)
    assert [i[0] for i in pod5_io.pod5_extract_read_ids(path)] == [rid]
    np.testing.assert_allclose(pod5_io.pod5_get_signal(path, rid), sig,
                               atol=0.1)
    with pytest.raises(RuntimeError):
        pod5_io.write_pod5(path, [(rid, sig)])       # VBZ needs zstd


def test_vbz_codec():
    rng = np.random.default_rng(2)
    x = rng.integers(-3000, 3000, 10000).astype(np.int16)
    enc = pod5_io.vbz_compress(x)
    dec = pod5_io.vbz_decompress(enc, x.shape[0])
    np.testing.assert_array_equal(dec, x)


@pytest.mark.parametrize("fmt", ["fast5", "pod5"])
def test_dataset_and_source(tmp_path, models, fmt):
    ds = build_dataset(os.path.join(tmp_path, fmt), models, n_reads=4,
                       read_length=1500, signal_format=fmt, seed=3)
    idx = parse_index(ds.index)
    assert len(idx) == 4
    ref = fasta_io.import_reference(ds.reference_fa)
    src = BamSignalSource(ds.bam, ref, idx, min_mapq=20, min_length=1000)
    recs = list(src)
    assert len(recs) == 4
    for r in recs:
        assert len(r.basecall) == 1500
        assert len(r.reference_seq) == 1500
        assert r.raw.shape[0] > 10000
        # sequencing-direction reference must equal basecall (perfect sim)
        assert r.reference_seq == r.basecall
        if r.is_reverse:
            assert ref["chrS"][r.ref_start : r.ref_end] == \
                reverse_complement(r.basecall)
        else:
            assert ref["chrS"][r.ref_start : r.ref_end] == r.basecall


def test_bedgraph_tool(tmp_path):
    from dnascent_tpu.tools import bedgraph
    detect = os.path.join(tmp_path, "x.detect")
    with open(detect, "w") as fh:
        fh.write("#Mode CNN\n>r1 chr1 100 200 fwd\n")
        for i in range(5):
            fh.write(f"{100+i}\t0.1\t0.9\tAAAATAAAA\n")
    out = os.path.join(tmp_path, "bg")
    n = bedgraph.convert_detect(detect, out, None)
    assert n == 1
    files = [f for d, _, fs in os.walk(out) for f in fs]
    assert any("BrdU" in f for f in files)
    assert any("EdU" in f for f in files)


def test_merge_host_outputs(tmp_path):
    from dnascent_tpu.parallel.merge import merge_host_outputs
    a = os.path.join(tmp_path, "out.host0")
    b = os.path.join(tmp_path, "out.host1")
    open(a, "w").write("#H\n>r2 chr1 500 600 fwd\n500\t0.1\t0.2\tK\n")
    open(b, "w").write("#H\n>r1 chr1 100 200 fwd\n100\t0.3\t0.4\tK\n"
                       ">r3 chr2 50 60 fwd\n50\t0.5\t0.6\tK\n")
    out = os.path.join(tmp_path, "out.detect")
    n = merge_host_outputs([a, b], out)
    assert n == 3
    text = open(out).read()
    # canonical (contig, start) order regardless of host layout
    assert text.index(">r1") < text.index(">r2") < text.index(">r3")
