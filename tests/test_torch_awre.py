"""awre (FormatFinder and its batched programs), auto_assign_labels and
to_pcapng against urh_tpu's.

The same seeded message sets go through urh_tpu.awre (JAX on the CPU, or
its NumPy twins where urh_tpu routes small inputs) and urh_tpu_torch.awre
(torch's CPU ops).  Everything here is integers, labels and bytes, so
every comparison is exact: the programs of awre/device.py, the message
types with their labels and members, and the pcapng file (urh_tpu's
functions called with the port's shb_userappl).
"""

import array
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from urh_tpu.awre import device as jax_dev
from urh_tpu.awre.format_finder import FormatFinder as JaxFormatFinder
from urh_tpu.coding.crc import GenericCRC as JaxGenericCRC
from urh_tpu.dev import pcapng as jax_pcapng
from urh_tpu_torch.awre import device as dev
from urh_tpu_torch.awre import kernels
from urh_tpu_torch.awre.format_finder import FormatFinder
from urh_tpu_torch.coding.crc import GenericCRC
from urh_tpu_torch.protocol.analyzer import ProtocolAnalyzer

torch.set_num_threads(1)

# widths around the power-of-two buckets of pack_messages
WIDTHS = (1, 7, 8, 9, 15, 16, 17, 63, 64, 65)


def _ragged(seed, n, alphabet=2, lengths=WIDTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, alphabet, size=int(rng.choice(lengths))).astype(np.uint8)
            for _ in range(n)]


def _packs():
    """Ragged packs: bits, nibbles, a wide alphabet, duplicates and
    shared prefixes."""
    bits = _ragged(1, 23)
    bits += [bits[0].copy(), np.concatenate([bits[3], [1, 0, 1]]).astype(np.uint8)]
    return {"bits": bits, "nibbles": _ragged(2, 17, alphabet=16),
            "bytes": _ragged(3, 9, alphabet=200), "pair": _ragged(4, 2),
            "one": _ragged(5, 1)}


PACKS = _packs()


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_pack_and_first_difference_matrix_equal_urh_tpu(pack):
    data, lengths = dev.pack_messages(PACKS[pack])
    jax_data, jax_lengths = jax_dev.pack_messages(PACKS[pack])
    np.testing.assert_array_equal(data, jax_data)
    np.testing.assert_array_equal(lengths, jax_lengths)
    got = dev.first_difference_matrix(data, lengths, device="cpu")
    np.testing.assert_array_equal(got, jax_dev.first_difference_matrix(data, lengths))
    if len(data) > 1:  # the JAX program itself, beside urh_tpu's routed call
        np.testing.assert_array_equal(got, np.asarray(jax_dev._first_diff_block_jax(
            jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(data), jnp.asarray(lengths))))


@pytest.mark.parametrize("alphabet", [2, 16, 255])
@pytest.mark.parametrize("pack", ["bits", "nibbles", "bytes"])
def test_column_agreement_equals_urh_tpu(pack, alphabet):
    data, lengths = dev.pack_messages(PACKS[pack])
    got = dev.column_agreement(data, lengths, alphabet, device="cpu")
    np.testing.assert_array_equal(got, jax_dev.column_agreement(data, lengths, alphabet))
    counts = dev._column_value_counts(torch.from_numpy(data), torch.from_numpy(lengths),
                                      alphabet).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jax_dev._column_value_counts_jax(
        jnp.asarray(data), jnp.asarray(lengths), alphabet)))


@pytest.mark.parametrize("n", list(range(1, 41)))
def test_ngram_values_and_seqnum_deltas_equal_urh_tpu(n):
    data, lengths = dev.pack_messages(PACKS["bits"])
    values, avail = dev.ngram_values(data, lengths, n, device="cpu")
    want_values, want_avail = jax_dev._ngram_matrix_np(data, lengths, n)
    np.testing.assert_array_equal(values, want_values)
    np.testing.assert_array_equal(avail, want_avail)
    jax_values, _ = jax_dev.ngram_values(data, lengths, n)
    np.testing.assert_array_equal(values, jax_values)
    np.testing.assert_array_equal(dev.seqnum_delta_matrix(data, lengths, n, device="cpu"),
                                  jax_dev.seqnum_delta_matrix(data, lengths, n))


def test_hexvectors_equal_urh_tpu():
    from urh_tpu.awre import kernels as jax_kernels

    for got, want in zip(kernels.get_hexvectors(PACKS["bits"], "cpu"),
                         jax_kernels.get_hexvectors(PACKS["bits"])):
        np.testing.assert_array_equal(got, want)


OCCURRENCE_CASES = {
    "bits": ("bits", ((1, 0, 1), (1,), (0, 0, 0, 0, 0, 0, 0, 0, 0), (1, 1)), ()),
    "bits, ignored columns": ("bits", ((1, 0), (0, 1, 1, 0)), (0, 3, 4, 5, 40, 1000)),
    "nibbles": ("nibbles", ((3, 4), (15,), tuple(range(10))), (2,)),
    "longer than most rows": ("bits", (tuple([1] * 40), tuple(PACKS["bits"][0][:3])), ()),
}


@pytest.mark.parametrize("case", sorted(OCCURRENCE_CASES))
def test_occurrences_equal_urh_tpu(case):
    pack, patterns, ignore = OCCURRENCE_CASES[case]
    patterns = [np.array(p, np.uint8) for p in patterns]
    data, lengths = dev.pack_messages(PACKS[pack])
    got = dev.occurrence_matrix(data, lengths, patterns, ignore, device="cpu")
    np.testing.assert_array_equal(got, jax_dev.occurrence_matrix(data, lengths, patterns,
                                                                 ignore))
    # chunked: blocks of rows and patterns give the same hits
    chunks = list(dev.iter_occurrence_chunks(data, lengths, patterns, ignore, max_cells=256,
                                             device="cpu"))
    assert len(chunks) > 1
    for (row_lo, pat_lo), hit in chunks:
        np.testing.assert_array_equal(
            hit, got[row_lo:row_lo + hit.shape[0], pat_lo:pat_lo + hit.shape[1]])
    assert (kernels.batch_find_occurrences(PACKS[pack], patterns, ignore, device="cpu")
            == __import__("urh_tpu.awre.kernels", fromlist=["x"]).batch_find_occurrences(
                PACKS[pack], patterns, ignore))


def _custom_crc(module, width, seed, **options):
    rng = np.random.default_rng(seed)
    poly = array.array("B", [1] + rng.integers(0, 2, width - 1).tolist() + [1])
    return module.GenericCRC(polynomial=poly, start_value=array.array(
        "B", rng.integers(0, 2, width).tolist()), final_xor=array.array(
        "B", rng.integers(0, 2, width).tolist()), **options)


CRC_CASES = {
    "CRC8 CCITT": lambda m: m.GenericCRC.from_standard_checksum("CRC8 CCITT"),
    "CRC16 CCITT": lambda m: m.GenericCRC.from_standard_checksum("CRC16 CCITT"),
    "CRC32": lambda m: m.GenericCRC.from_standard_checksum("CRC32 (default)"),
    "reflected": lambda m: _custom_crc(m, 16, 1, reverse_polynomial=True, reverse_all=True,
                                       lsb_first=True),
    "little endian": lambda m: _custom_crc(m, 16, 2, little_endian=True),
    "40 bits": lambda m: _custom_crc(m, 40, 3),
    "64 bits, reflected, little endian": lambda m: _custom_crc(
        m, 64, 4, reverse_all=True, lsb_first=True, little_endian=True),
}


@pytest.mark.parametrize("length", [8, 33, 130])
@pytest.mark.parametrize("case", sorted(CRC_CASES))
def test_batched_crc_equals_urh_tpu(case, length):
    import urh_tpu.coding.crc
    import urh_tpu_torch.coding.crc

    crc = CRC_CASES[case](urh_tpu_torch.coding.crc)
    jax_crc = CRC_CASES[case](urh_tpu.coding.crc)
    messages = np.random.default_rng(length).integers(0, 2, (6, length)).astype(np.uint8)
    got = dev.batched_crc(messages, *crc.get_parameters(), device="cpu")
    np.testing.assert_array_equal(got, jax_dev.batched_crc(messages, *jax_crc.get_parameters()))
    for row, value in zip(messages, got):  # the bitwise CRC itself, as int64 holds it
        bits = crc.crc(array.array("B", row.tolist()))
        assert int(value) % (1 << 64) == kernels.bit_array_to_number(bits, len(bits))


def _module(package, name):
    return importlib.import_module(f"{package}.{name}")


def _bench_protocol(package, n_msgs):
    """bench.py's awre protocol (bench.py:556-592) built by package's own
    ProtocolGenerator, every message on one shared empty message type."""
    labels = _module(package, "protocol.labels")
    f = labels.FieldType.Function
    alice = labels.Participant("Alice", address_hex="1337")
    bob = labels.Participant("Bob", address_hex="4711")
    mb = _module(package, "awre.message_type_builder").MessageTypeBuilder("data")
    for function, width in ((f.PREAMBLE, 16), (f.SYNC, 16), (f.LENGTH, 8), (f.SRC_ADDRESS, 16),
                            (f.DST_ADDRESS, 16), (f.SEQUENCE_NUMBER, 8)):
        mb.add_label(function, width)
    pg = _module(package, "awre.protocol_generator").ProtocolGenerator(
        [mb.message_type], syncs_by_mt={mb.message_type: "0x9a7d"}, participants=[alice, bob])
    rng = np.random.default_rng(42)
    for i in range(n_msgs):
        data = "".join(rng.choice(["0", "1"], size=16 if i % 2 else 32))
        src, dst = (alice, bob) if i % 2 else (bob, alice)
        pg.generate_message(data=data, source=src, destination=dst)
    return pg.messages


def _without_preamble(package):
    """tests/test_awre_generated_protocols.py:test_without_preamble."""
    labels = _module(package, "protocol.labels")
    f = labels.FieldType.Function
    alice = labels.Participant("Alice", address_hex="24")
    broadcast = labels.Participant("Broadcast", address_hex="ff")
    mb = _module(package, "awre.message_type_builder").MessageTypeBuilder("data")
    for function, width in ((f.SYNC, 16), (f.LENGTH, 8), (f.SRC_ADDRESS, 8),
                            (f.SEQUENCE_NUMBER, 8)):
        mb.add_label(function, width)
    pg = _module(package, "awre.protocol_generator").ProtocolGenerator(
        [mb.message_type], syncs_by_mt={mb.message_type: "0x8e88"},
        preambles_by_mt={mb.message_type: "10" * 8}, participants=[alice, broadcast])
    for i in range(20):
        data_bits = 16 if i % 2 == 0 else 32
        pg.generate_message(data="1010" * (data_bits // 4), source=pg.participants[i % 2],
                            destination=pg.participants[(i + 1) % 2])
    return pg.messages


def _checksums(package):
    """tests/test_awre.py:test_checksum_in_generated_protocol: two message
    types with CRC16 CCITT checksums."""
    labels = _module(package, "protocol.labels")
    crc = _module(package, "coding.crc").GenericCRC
    f = labels.FieldType.Function
    builder = _module(package, "awre.message_type_builder").MessageTypeBuilder
    types = []
    for name, width in (("data", 32), ("data2", 16)):
        mb = builder(name)
        for function, w in ((f.PREAMBLE, 8), (f.SYNC, 16), (f.LENGTH, 8), (f.DATA, width)):
            mb.add_label(function, w)
        mb.add_checksum_label(16, crc.from_standard_checksum("CRC16 CCITT"))
        types.append(mb.message_type)
    pg = _module(package, "awre.protocol_generator").ProtocolGenerator(
        types, syncs_by_mt={mt: "0x1234" for mt in types})
    for i in range(5):
        pg.generate_message(data="{0:032b}".format(i), message_type=types[0])
        pg.generate_message(data="{0:016b}".format(i), message_type=types[1])
    return pg.messages


def _length_and_ack(package):
    """tests/test_awre_engines_more.py:test_length_medium_protocol: a data
    type with length and sequence number beside an acknowledgement."""
    labels = _module(package, "protocol.labels")
    f = labels.FieldType.Function
    builder = _module(package, "awre.message_type_builder").MessageTypeBuilder
    mb1, mb2 = builder("data"), builder("ack")
    for function in (f.PREAMBLE, f.SYNC, f.LENGTH, f.SEQUENCE_NUMBER):
        mb1.add_label(function, 8)
    for function in (f.PREAMBLE, f.SYNC):
        mb2.add_label(function, 8)
    pg = _module(package, "awre.protocol_generator").ProtocolGenerator(
        [mb1.message_type, mb2.message_type],
        syncs_by_mt={mb1.message_type: "11110011", mb2.message_type: "11110011"})
    for data_length, num_messages in {8: 5, 16: 10, 32: 5}.items():
        for i in range(num_messages):
            pg.generate_message(data=pg.decimal_to_bits(10 * i, data_length),
                                message_type=mb1.message_type)
            pg.generate_message(message_type=mb2.message_type, data="0xaf")
    return pg.messages


PROTOCOLS = {
    "bench.py, 100 messages": lambda package: _bench_protocol(package, 100),
    "without preamble": _without_preamble,
    "checksums": _checksums,
    "length and ack": _length_and_ack,
}


def _clear(package, messages):
    empty = _module(package, "protocol.labels").MessageType("empty")
    for msg in messages:
        msg.message_type = empty
    return messages


def _found(ff):
    """Message types (name, labels as (name, start, end, field type)),
    their members, the checksums and the learned addresses of a finder."""
    types = [(mt.name, [(lbl.name, int(lbl.start), int(lbl.end),
                         lbl.field_type.function.name if lbl.field_type else None,
                         getattr(getattr(lbl, "checksum", None), "caption", None))
                        for lbl in mt])
             for mt in ff.message_types]
    members = sorted((mt.name, sorted(int(i) for i in indices))
                     for mt, indices in ff.existing_message_types.items())
    addresses = {int(k): bytes(np.asarray(v, np.uint8))
                 for k, v in ff.known_participant_addresses.items()}
    return types, members, list(map(int, ff.sync_ends)), addresses


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_format_finder_equals_urh_tpu(protocol):
    messages = _clear("urh_tpu_torch", PROTOCOLS[protocol]("urh_tpu_torch"))
    jax_messages = _clear("urh_tpu", PROTOCOLS[protocol]("urh_tpu"))
    bits = [m.plain_bits_str for m in messages]
    assert bits == [m.plain_bits_str for m in jax_messages]  # the same protocol first
    ff = FormatFinder(messages, device="cpu")
    jax_ff = JaxFormatFinder(jax_messages)
    ff.run(max_iterations=10)
    jax_ff.run(max_iterations=10)
    found = _found(ff)
    assert found == _found(jax_ff)
    assert found[0] and all(labels for _, labels in found[0])
    assert [m.plain_bits_str for m in messages] == bits  # the messages are unchanged


def test_one_message_type_a_message_when_each_starts_on_its_own():
    """ROADMAP.md §C: bench.py's protocol with a fresh empty type on every
    message comes back as one type a message, in urh_tpu and in the port."""
    found = []
    for package, finder, kwargs in (("urh_tpu_torch", FormatFinder, {"device": "cpu"}),
                                    ("urh_tpu", JaxFormatFinder, {})):
        labels = _module(package, "protocol.labels")
        messages = _bench_protocol(package, 12)
        for msg in messages:
            msg.message_type = labels.MessageType("empty")
        ff = finder(messages, **kwargs)
        ff.run(max_iterations=10)
        found.append(_found(ff))
    assert found[0] == found[1]
    assert len(found[0][0]) == 12


def test_auto_assign_labels_equals_urh_tpu():
    from urh_tpu.protocol.analyzer import ProtocolAnalyzer as JaxProtocolAnalyzer

    messages = _clear("urh_tpu_torch", _checksums("urh_tpu_torch"))
    jax_messages = _clear("urh_tpu", _checksums("urh_tpu"))
    sig = __import__("urh_tpu_torch").Signal.from_iq(np.zeros((10, 2), np.float32),
                                                      device="cpu")
    proto, jax_proto = ProtocolAnalyzer(sig), JaxProtocolAnalyzer(None)
    proto.messages, jax_proto.messages = messages, jax_messages
    proto.auto_assign_labels()  # on the signal's device, the CPU
    jax_proto.auto_assign_labels()
    assert ([mt.name for mt in proto.message_types]
            == [mt.name for mt in jax_proto.message_types])
    assert len(proto.message_types) == 2
    for msg, ref in zip(proto.messages, jax_proto.messages):
        assert msg.message_type.name == ref.message_type.name
        assert ([(lbl.name, lbl.start, lbl.end) for lbl in msg.message_type]
                == [(lbl.name, lbl.start, lbl.end) for lbl in ref.message_type])


def test_auto_assign_labels_without_a_signal_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proto = ProtocolAnalyzer(None)
    proto.messages = _clear("urh_tpu_torch", _checksums("urh_tpu_torch"))
    with pytest.raises(RuntimeError, match="CUDA"):
        proto.auto_assign_labels()
    with pytest.raises(RuntimeError, match="CUDA"):
        FormatFinder(proto.messages)


def test_to_pcapng_equals_urh_tpu(tmp_path):
    proto = ProtocolAnalyzer.get_protocol_from_string(
        ["1010111100001111/10ms", "10/1s", "", "11110000" * 5 + "1/2", "1" * 37],
        sample_rate=1e6)
    for i, msg in enumerate(proto.messages):
        msg.timestamp = 1.5e9 + 0.25 * i
    path = tmp_path / "port.pcapng"
    proto.to_pcapng(str(path), hardware_desc_name="HackRF", link_type=148)
    want = tmp_path / "ref.pcapng"
    jax_pcapng.create_pcapng_file(str(want), shb_userappl="urh_tpu_torch",
                                  shb_hardware="HackRF", link_type=148)
    jax_pcapng.append_packets_to_pcapng(
        str(want), packets=(msg.decoded_ascii_buffer for msg in proto.messages),
        timestamps=(msg.timestamp for msg in proto.messages))
    assert path.read_bytes() == want.read_bytes()
    assert b"urh_tpu_torch" in path.read_bytes() and len(proto.messages) == 4


def test_generic_crc_copies_agree():
    for name in ("CRC8 CCITT", "CRC16 CCITT", "CRC32 (default)"):
        assert (GenericCRC.from_standard_checksum(name).get_parameters()
                == JaxGenericCRC.from_standard_checksum(name).get_parameters())
