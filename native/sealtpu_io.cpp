// sealtpu_io: native host-side serialization runtime for seal_embedded_jax.
//
// The reference keeps serialization in native code on both sides of the wire
// (device/lib/fileops.c, adapter/fileops.cpp).  This library is the
// This framework's equivalent for the host: batched 2-bit ternary key
// pack/unpack, ciphertext component (de)serialization, and the reference's
// "name : { v0, v1, ... }" text-poly format, all exposed through a C ABI for
// ctypes.  Formats match adapter/fileops.cpp:29-172 (sk) and
// device/util_print.h:499 (text polys).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cerrno>
#include <string>
#include <vector>

extern "C" {

// ---- 2-bit ternary packing (4 coeffs per byte, big-endian within byte) ----

// signed {-1,0,1} -> packed file encoding {0,1,2}
void se_pack_ternary(const int8_t* signed_vals, size_t n, uint8_t* out) {
    std::memset(out, 0, (n + 3) / 4);
    for (size_t i = 0; i < n; i++) {
        uint8_t v = (uint8_t)(signed_vals[i] + 1);
        out[i / 4] |= (uint8_t)(v << (6 - (i % 4) * 2));
    }
}

void se_unpack_ternary(const uint8_t* packed, size_t n, int8_t* out) {
    for (size_t i = 0; i < n; i++) {
        out[i] = (int8_t)(((packed[i / 4] >> (6 - (i % 4) * 2)) & 0x3) - 1);
    }
}

// expand packed ternary to mod-q u32 (0 -> q-1, 1 -> 0, 2 -> 1)
void se_expand_ternary_modq(const uint8_t* packed, size_t n, uint32_t q,
                            uint32_t* out) {
    for (size_t i = 0; i < n; i++) {
        uint8_t v = (packed[i / 4] >> (6 - (i % 4) * 2)) & 0x3;
        out[i] = (v == 0) ? (q - 1) : (uint32_t)(v - 1);
    }
}

// ---- ciphertext component bytes (u32 little-endian) ----

// Batched serialize: components (count, n) u32 -> contiguous LE bytes.
void se_ct_to_bytes(const uint32_t* comps, size_t count, size_t n,
                    uint8_t* out) {
    // Little-endian hosts: straight memcpy; byte-swap otherwise.
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    std::memcpy(out, comps, count * n * 4);
#else
    for (size_t i = 0; i < count * n; i++) {
        uint32_t v = comps[i];
        out[4 * i] = v & 0xFF;
        out[4 * i + 1] = (v >> 8) & 0xFF;
        out[4 * i + 2] = (v >> 16) & 0xFF;
        out[4 * i + 3] = (v >> 24) & 0xFF;
    }
#endif
}

// ---- text poly format ("name : { v0, v1, ... }") ----

// Formats one poly line; returns bytes written (excl. NUL), or required
// size if out == nullptr.
size_t se_format_poly(const char* name, const uint32_t* vals, size_t n,
                      char* out, size_t out_cap) {
    std::string s(name);
    s += " : { ";
    char buf[16];
    for (size_t i = 0; i < n; i++) {
        int k = std::snprintf(buf, sizeof buf, "%u", vals[i]);
        s.append(buf, (size_t)k);
        if (i + 1 < n) s += ", ";
    }
    s += " }\n";
    if (out && out_cap > s.size()) {
        std::memcpy(out, s.data(), s.size());
        out[s.size()] = 0;
        return s.size();
    }
    return s.size();
}

// Parses the *values* of one "name : { ... }" line into vals (u32), returns
// count parsed or (size_t)-1 on error.
size_t se_parse_poly(const char* line, uint32_t* vals, size_t cap) {
    const char* p = std::strchr(line, '{');
    if (!p) return (size_t)-1;
    p++;
    size_t count = 0;
    while (*p && count < cap) {
        while (*p == ' ' || *p == ',') p++;
        if (*p == '}' || !*p) break;
        char* end = nullptr;
        unsigned long v = std::strtoul(p, &end, 10);
        if (end == p) return (size_t)-1;
        vals[count++] = (uint32_t)v;
        p = end;
    }
    return count;
}

}  // extern "C"

// ---- streaming senders (device/lib/network.{h,c} analog) ----
//
// The reference streams each RNS component as it is produced, through
// native code (curl POST on the Sphere A7; SEND_FNCT_PTR elsewhere,
// seal_embedded.c:180-204).  These handles implement the framework's
// host-side equivalent natively: 4-byte LE length framing over a file or
// TCP socket, with a batched entry point that frames and writes a whole
// (count, n) block of u32 components without per-component FFI or
// Python-loop overhead.

#include <fcntl.h>
#include <unistd.h>
#include <netdb.h>
#include <sys/socket.h>

namespace {
struct Stream {
    int fd = -1;
    bool is_socket = false;
};
std::vector<Stream> g_streams;

bool write_all(int fd, const uint8_t* p, size_t len) {
    while (len) {
        ssize_t k = ::write(fd, p, len);
        if (k <= 0) {
            if (k < 0 && errno == EINTR) continue;
            return false;
        }
        p += (size_t)k;
        len -= (size_t)k;
    }
    return true;
}
}  // namespace

extern "C" {

// Returns a handle >= 0, or -1 on error.  Appends to `path`.
int64_t se_stream_open_file(const char* path) {
    int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
    if (fd < 0) return -1;
    g_streams.push_back({fd, false});
    return (int64_t)g_streams.size() - 1;
}

int64_t se_stream_open_tcp(const char* host, int port) {
    char svc[16];
    std::snprintf(svc, sizeof svc, "%d", port);
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host, svc, &hints, &res) != 0) return -1;
    int fd = -1;
    for (addrinfo* a = res; a; a = a->ai_next) {
        fd = ::socket(a->ai_family, a->ai_socktype, a->ai_protocol);
        if (fd < 0) continue;
        if (::connect(fd, a->ai_addr, a->ai_addrlen) == 0) break;
        ::close(fd);
        fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0) return -1;
    g_streams.push_back({fd, true});
    return (int64_t)g_streams.size() - 1;
}

// One framed blob; returns payload bytes written or -1.
int64_t se_stream_send(int64_t h, const uint8_t* data, size_t len) {
    if (h < 0 || (size_t)h >= g_streams.size()) return -1;
    int fd = g_streams[(size_t)h].fd;
    uint8_t hdr[4] = {(uint8_t)(len & 0xFF), (uint8_t)((len >> 8) & 0xFF),
                      (uint8_t)((len >> 16) & 0xFF),
                      (uint8_t)((len >> 24) & 0xFF)};
    if (!write_all(fd, hdr, 4) || !write_all(fd, data, len)) return -1;
    return (int64_t)len;
}

// Batched: frames and writes `count` components of n u32 words each
// (little-endian on LE hosts via direct copy) — the per-prime streaming
// loop in one native call.  Returns total payload bytes or -1.
int64_t se_stream_send_components(int64_t h, const uint32_t* comps,
                                  size_t count, size_t n) {
    int64_t total = 0;
    for (size_t c = 0; c < count; c++) {
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
        int64_t k = se_stream_send(h, (const uint8_t*)(comps + c * n),
                                   n * 4);
#else
        std::vector<uint8_t> buf(n * 4);
        se_ct_to_bytes(comps + c * n, 1, n, buf.data());
        int64_t k = se_stream_send(h, buf.data(), n * 4);
#endif
        if (k < 0) return -1;
        total += k;
    }
    return total;
}

int se_stream_close(int64_t h) {
    if (h < 0 || (size_t)h >= g_streams.size()) return -1;
    int fd = g_streams[(size_t)h].fd;
    if (fd >= 0) ::close(fd);
    g_streams[(size_t)h].fd = -1;
    return 0;
}

}  // extern "C"
