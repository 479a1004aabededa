"""Native serialization runtime (native/sealtpu_io.cpp via io.native):
must agree byte-for-byte with the pure-Python io.serialize reference."""

import subprocess
import pathlib

import numpy as np
import pytest

from seal_embedded_jax.io import native, serialize

REPO = pathlib.Path(__file__).parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        subprocess.run(["make", "-C", str(REPO / "native")], check=True)
        native._LIB = None
    assert native.available()


def test_pack_unpack_ternary_matches_python():
    rng = np.random.default_rng(0)
    signed = (rng.integers(0, 3, 4096) - 1).astype(np.int8)
    packed = native.pack_ternary_signed(signed)
    # Python reference: map -1/0/1 -> 0/1/2, 4 coeffs/byte MSB-first
    # (adapter/fileops.cpp:70-73).
    want = serialize.pack_ternary([int(v) + 1 for v in signed])
    assert packed == want
    back = native.unpack_ternary_signed(packed, 4096)
    assert np.array_equal(back.astype(np.int32), signed.astype(np.int32))


def test_expand_ternary_modq_matches_python():
    rng = np.random.default_rng(1)
    signed = (rng.integers(0, 3, 1024) - 1).astype(np.int8)
    packed = native.pack_ternary_signed(signed)
    q = 1053818881
    got = native.expand_ternary_modq(packed, 1024, q)
    want = np.where(signed < 0, np.int64(q - 1),
                    signed.astype(np.int64)).astype(np.uint32)
    assert np.array_equal(got, want)


def test_ct_to_bytes_matches_python():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2 ** 30, (3, 256)).astype(np.uint32)
    got = native.ct_to_bytes(c)
    want = b"".join(serialize.ct_component_bytes(row) for row in c)
    assert got == want


def test_format_parse_poly_roundtrip_matches_python():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2 ** 30, 64).astype(np.uint32)
    line = native.format_poly("c0 (t0 p0)", vals)
    pyline = serialize.format_poly("c0 (t0 p0)", vals)
    assert line.strip() == pyline.strip()
    back = native.parse_poly(line)
    assert np.array_equal(back, vals)


def test_native_stream_file_matches_python_framing(tmp_path):
    """NativeStream.to_file + send_components produce exactly the bytes of
    io.network.file_sink fed by serialize.ct_component_bytes."""
    from seal_embedded_jax.io import native, network, serialize

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(0)
    comps = rng.integers(0, 2 ** 32, (4, 64)).astype(np.uint32)

    p_native = tmp_path / "native.bin"
    st = native.NativeStream.to_file(str(p_native))
    total = st.send_components(comps)
    st(b"trailing-blob")          # callback form too
    st.close()
    assert total == comps.size * 4

    p_py = tmp_path / "py.bin"
    send = network.file_sink(str(p_py))
    for c in comps:
        send(serialize.ct_component_bytes(c))
    send(b"trailing-blob")
    assert p_native.read_bytes() == p_py.read_bytes()
    # and the reader round-trips
    back = network.read_components(str(p_native))
    assert len(back) == 5
    assert np.array_equal(
        np.frombuffer(back[0], dtype="<u4"), comps[0])


def test_native_stream_tcp_roundtrip():
    """Native TCP sender against a localhost server thread."""
    import socket
    import threading
    from seal_embedded_jax.io import native

    if not native.available():
        pytest.skip("native library not built")
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    received = []

    def serve():
        conn, _ = srv.accept()
        buf = b""
        while len(received) < 2:
            data = conn.recv(65536)
            if not data:
                break
            buf += data
            while len(buf) >= 4:
                ln = int.from_bytes(buf[:4], "little")
                if len(buf) < 4 + ln:
                    break
                received.append(buf[4:4 + ln])
                buf = buf[4 + ln:]
        conn.close()

    th = threading.Thread(target=serve)
    th.start()
    st = native.NativeStream.to_tcp("127.0.0.1", port)
    comps = np.arange(32, dtype=np.uint32).reshape(1, 32)
    st.send_components(comps)
    st(b"hello")
    st.close()
    th.join(timeout=10)
    srv.close()
    assert np.array_equal(np.frombuffer(received[0], dtype="<u4"), comps[0])
    assert received[1] == b"hello"
