// The volume server's native data plane: framed-TCP needle IO served by
// C++ threads, with no Python interpreter on the path (`volume -dataplane
// native`).  The port's copy of seaweedfs_tpu/native/dataplane.cpp, the
// reference's GIL-free data plane.  A thread-per-connection TCP server
// speaks the framing of utils/framing.py:
//
//   request:  op(1) | key_len(u16 BE) | key utf8 | body_len(u32 BE) | body
//   response: status(1, 0=ok)         | payload_len(u32 BE) | payload
//
// Ops: 'W' append needle (key=fid, body=data) -> u32 stored size
//      'R' read needle   (key=fid)            -> needle data
//      'D' delete        (key=fid)            -> u32 freed size
// The batched 'B' and 'P' ops stay with the Python plane (tcp.py).  The
// port adds dp_frames: the frames served, by op.
//
// Byte formats are those of storage/needle.py and storage/idx.py (and of
// the reference's Go and Python volumes):
//   needle v3 record (needle_read_write.go):
//     cookie u32 BE | id u64 BE | size i32 BE
//     [data_size u32 BE | data | flags u8]           when data_size > 0
//     masked_crc32c(data) u32 BE | append_at_ns u64 BE
//     padding 1..8: (size BE4 ++ zeros)[0:pad]
//   idx entry (idx/walk.go): key u64 BE | offset/8 u32 BE | size i32 BE
// so the plane takes only version 3 volumes with 4-byte offsets.
//
// Coherence with the Python Store (volume_server/store.py): while a volume
// is registered here, this plane is the ONLY writer and reader of its
// needles (the HTTP handlers funnel through dp_append/dp_read_record/
// dp_delete via ctypes); maintenance (vacuum, EC, copy, tier) first
// dp_remove_volume()s it, works on quiesced files, and re-registers, which
// rebuilds the map from the idx.  A durable write's group sync fsyncs the
// .dat, then the .idx, as storage/volume_write.py's batches do.
//
// Build (ops/_build.py, at first use):
//   c++ -O3 -shared -fPIC -std=c++17 -pthread -o libdataplane.so
//       dataplane.cpp -lz

#include <algorithm>
#include <arpa/inet.h>
#include <memory>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <sys/stat.h>
#include <atomic>
#include <condition_variable>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <zlib.h>

namespace {

// ---------------------------------------------------------------- crc32c
#if defined(__x86_64__)
#include <cpuid.h>
static bool has_sse42() {
    unsigned a, b, c, d;
    if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
    return (c & (1u << 20)) != 0;  // SSE4.2
}
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t* p, size_t n) {
    crc = ~crc;
    while (n >= 8) {
        uint64_t v;
        memcpy(&v, p, 8);
        crc = (uint32_t)__builtin_ia32_crc32di(crc, v);
        p += 8; n -= 8;
    }
    while (n--) crc = __builtin_ia32_crc32qi(crc, *p++);
    return ~crc;
}
#endif

static uint32_t crc_table[256];
static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        crc_table[i] = c;
    }
}
static uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t n) {
    crc = ~crc;
    while (n--) crc = crc_table[(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

static bool g_hw_crc = false;
static uint32_t crc32c(const uint8_t* p, size_t n) {
#if defined(__x86_64__)
    if (g_hw_crc) return crc32c_hw(0, p, n);
#endif
    return crc32c_sw(0, p, n);
}

static uint32_t masked_crc(uint32_t c) {
    // crc.go:24-26: rotr15(c) + 0xa282ead8
    uint32_t rot = (c >> 15) | (c << 17);
    return rot + 0xA282EAD8u;
}

// ------------------------------------------------------------- BE helpers
static void put_u32(uint8_t* p, uint32_t v) {
    p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
static void put_u64(uint8_t* p, uint64_t v) {
    for (int i = 7; i >= 0; i--) { p[i] = (uint8_t)v; v >>= 8; }
}
static uint16_t get_u16(const uint8_t* p) {
    return ((uint16_t)p[0] << 8) | p[1];
}
static uint32_t get_u32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | p[3];
}
static uint64_t get_u64(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
    return v;
}

// error codes surfaced to Python / the wire
enum {
    DP_OK = 0, DP_NOT_FOUND = -2, DP_COOKIE = -3, DP_DELETED = -4,
    DP_READONLY = -5, DP_NO_VOLUME = -6, DP_IO = -7, DP_CRC = -8,
    DP_BAD_REQ = -9, DP_FULL = -10, DP_TCP_FORBIDDEN = -11,
};

// ------------------------------------------------------------- volume
struct NeedleVal { uint64_t offset; int32_t size; };

struct Volume {
    int dat_fd = -1;
    int idx_fd = -1;
    uint64_t dat_size = 0;   // append offset
    uint64_t idx_size = 0;   // idx append offset (rollback anchor)
    uint64_t max_key = 0;    // highest needle id seen (heartbeat reseed)
    uint64_t deleted_bytes = 0;  // stored sizes of dead needles (vacuum)
    bool read_only = false;
    // W/D frames arriving over TCP are rejected unless this is set: the
    // TCP plane has no IP-whitelist slot and no replication fan-out, so
    // the Python side only enables it for replication-000 volumes on
    // servers with no whitelist configured.  Local C-API calls
    // (dp_write/dp_append/dp_delete, the HTTP plane's funnel) are never
    // gated by it — the HTTP layer already enforced whitelist+fan-out.
    bool tcp_writable = true;
    bool retired = false;    // set under write_mu by dp_remove_volume
    std::unordered_map<uint64_t, NeedleVal> map;
    std::mutex write_mu;     // serializes append (.dat + .idx + map)
    std::mutex map_mu;       // guards map for lock-free-ish readers
    // group-commit fsync (volume_write.go's batch worker analog): many
    // concurrent durable writers share one fsync pass
    std::mutex sync_mu;
    std::condition_variable sync_cv;
    uint64_t sync_pending = 0;   // highest requested generation
    uint64_t sync_done = 0;      // highest completed generation
    uint64_t sync_passes = 0;    // actual fsync() pairs performed
    bool sync_failed = false;    // PERMANENTLY sticky: a failed fsync
                                 // drops dirty pages (appends from ANY
                                 // generation) and clears the kernel
                                 // error, so no later pass can prove
                                 // durability — every durable write on
                                 // this registration fails until the
                                 // operator re-registers the volume
    bool sync_running = false;

    ~Volume() {
        if (dat_fd >= 0) close(dat_fd);
        if (idx_fd >= 0) close(idx_fd);
    }
};

using VolumeRef = std::shared_ptr<Volume>;

constexpr int32_t TOMBSTONE = -1;
constexpr uint8_t FLAG_IS_COMPRESSED = 0x01;

static const char* dp_strerror(int code) {
    switch (code) {
        case DP_NOT_FOUND: return "not found";
        case DP_COOKIE:    return "cookie mismatch";
        case DP_DELETED:   return "already deleted";
        case DP_READONLY:  return "volume is read only";
        case DP_NO_VOLUME: return "volume not on native plane";
        case DP_IO:        return "io error";
        case DP_CRC:       return "crc mismatch";
        case DP_FULL:      return "volume size limit exceeded";
        case DP_TCP_FORBIDDEN:
            return "tcp writes not allowed for this volume";
        default:           return "bad request";
    }
}

struct Server {
    int listen_fd = -1;
    int port = 0;
    std::thread accept_thread;
    std::mutex vol_mu;
    std::unordered_map<uint32_t, VolumeRef> volumes;
    struct ConnThread {
        std::thread t;
        std::shared_ptr<std::atomic<bool>> done;
    };
    std::mutex conn_mu;
    std::unordered_set<int> conns;
    std::vector<ConnThread> conn_threads;  // reaped on accept + dp_stop
    volatile bool stopping = false;
    // frames served over TCP, by op (W, R, D): what a client sent the
    // plane itself, never the HTTP funnel's calls
    std::atomic<unsigned long long> frames_w{0}, frames_r{0}, frames_d{0};
};

// Returns an owning reference: in-flight ops keep the Volume (and its
// fds) alive across a concurrent dp_remove_volume; writers additionally
// observe `retired` under write_mu so a quiesced volume takes no more
// appends after the remove returns.
static VolumeRef find_volume(Server* s, uint32_t vid) {
    std::lock_guard<std::mutex> g(s->vol_mu);
    auto it = s->volumes.find(vid);
    return it == s->volumes.end() ? nullptr : it->second;
}

// Group-commit durable sync: every caller whose appends happened before
// its generation is covered by ONE fsync pass; appends are NOT blocked
// while the pass runs (fsync happens outside write_mu).
static int vol_group_sync(Volume* v) {
    std::unique_lock<std::mutex> lk(v->sync_mu);
    if (v->sync_failed) return DP_IO;
    uint64_t my_gen = ++v->sync_pending;
    for (;;) {
        if (v->sync_failed) return DP_IO;
        if (v->sync_done >= my_gen) return DP_OK;
        if (!v->sync_running) {
            v->sync_running = true;
            uint64_t target = v->sync_pending;
            lk.unlock();
            int rc = DP_OK;
            if (fsync(v->dat_fd) != 0 || fsync(v->idx_fd) != 0)
                rc = DP_IO;
            lk.lock();
            v->sync_running = false;
            v->sync_done = target;
            if (rc != DP_OK)
                v->sync_failed = true;
            v->sync_passes++;
            v->sync_cv.notify_all();
            continue;  // loop observes sync_done / sync_failed
        }
        v->sync_cv.wait(lk);
    }
}

// needle record size on disk for a stored `size` (types.go GetActualSize)
static uint64_t actual_size(int32_t size) {
    uint64_t used = 16 + (uint64_t)size + 4 + 8;      // header+body+crc+ts
    uint64_t pad = 8 - (used % 8);                    // 1..8, never 0
    return used + pad;
}

// Append one 16-byte idx entry (caller holds write_mu).  On a failed or
// short write (ENOSPC) roll BOTH files back: a torn, 16-misaligned idx
// tail would misparse every later entry on the next replay, and the .dat
// record at `dat_off` would have no idx entry and resurface as a torn
// tail — mirror the .dat rollback the write paths already do.
static int idx_append(Volume* v, const uint8_t* ie, uint64_t dat_off) {
    if (write(v->idx_fd, ie, 16) != 16) {
        (void)!ftruncate(v->idx_fd, (off_t)v->idx_size);
        (void)!ftruncate(v->dat_fd, (off_t)dat_off);
        return DP_IO;
    }
    v->idx_size += 16;
    return DP_OK;
}

// ------------------------------------------------------------- ops
constexpr uint64_t MAX_VOLUME_BYTES = 8ull * 0xFFFFFFFFull;  // u32 off/8

static int vol_write(Volume* v, uint64_t id, uint32_t cookie,
                     const uint8_t* data, uint32_t len, uint32_t* out_size) {
    if (v->read_only) return DP_READONLY;
    std::lock_guard<std::mutex> g(v->write_mu);
    if (v->retired) return DP_NO_VOLUME;
    // cookie check against an existing live needle (volume_write.go)
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it != v->map.end() && it->second.size >= 0) {
            uint8_t hdr[4];
            if (pread(v->dat_fd, hdr, 4, it->second.offset) == 4 &&
                get_u32(hdr) != cookie)
                return DP_COOKIE;
        }
    }
    int32_t size = len > 0 ? (int32_t)(4 + len + 1) : 0;
    uint64_t rec_len = actual_size(size);
    if (v->dat_size + rec_len > MAX_VOLUME_BYTES)
        return DP_FULL;  // idx offsets are u32 of off/8 (offset_4bytes.go)
    std::vector<uint8_t> rec(rec_len);
    uint8_t* p = rec.data();
    put_u32(p, cookie); put_u64(p + 4, id); put_u32(p + 12, (uint32_t)size);
    size_t i = 16;
    if (len > 0) {
        put_u32(p + i, len); i += 4;
        memcpy(p + i, data, len); i += len;
        p[i++] = 0;  // flags
    }
    uint32_t crc = masked_crc(crc32c(data, len));
    put_u32(p + i, crc); i += 4;
    uint64_t now_ns = (uint64_t)std::chrono::duration_cast<
        std::chrono::nanoseconds>(std::chrono::system_clock::now()
                                      .time_since_epoch()).count();
    put_u64(p + i, now_ns); i += 8;
    // padding quirk (needle_read_write.go): size BE4 then zeros
    uint8_t padsrc[12] = {0};
    put_u32(padsrc, (uint32_t)size);
    size_t pad = rec_len - i;
    memcpy(p + i, padsrc, pad);

    uint64_t off = v->dat_size;
    if (pwrite(v->dat_fd, rec.data(), rec_len, off) != (ssize_t)rec_len) {
        (void)!ftruncate(v->dat_fd, off);
        return DP_IO;
    }
    uint8_t ie[16];
    put_u64(ie, id); put_u32(ie + 8, (uint32_t)(off / 8));
    put_u32(ie + 12, (uint32_t)size);
    if (idx_append(v, ie, off) != DP_OK) return DP_IO;
    v->dat_size = off + rec_len;
    if (id > v->max_key) v->max_key = id;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it != v->map.end() && it->second.size >= 0)
            v->deleted_bytes += (uint64_t)it->second.size;  // overwritten
        v->map[id] = NeedleVal{off, size};
    }
    *out_size = (uint32_t)size;
    return DP_OK;
}

static int vol_delete(Volume* v, uint64_t id, uint32_t cookie,
                      uint32_t* out_size) {
    if (v->read_only) return DP_READONLY;
    std::lock_guard<std::mutex> g(v->write_mu);
    if (v->retired) return DP_NO_VOLUME;
    NeedleVal nv;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it == v->map.end() || it->second.size < 0) {
            *out_size = 0;
            return DP_OK;  // double delete returns 0 (volume_write.go)
        }
        nv = it->second;
    }
    // append a zero-data tombstone needle, then log (key, off, -1)
    uint64_t rec_len = actual_size(0);
    std::vector<uint8_t> rec(rec_len);
    uint8_t* p = rec.data();
    put_u32(p, cookie); put_u64(p + 4, id); put_u32(p + 12, 0);
    uint32_t crc = masked_crc(crc32c(nullptr, 0));
    put_u32(p + 16, crc);
    uint64_t now_ns = (uint64_t)std::chrono::duration_cast<
        std::chrono::nanoseconds>(std::chrono::system_clock::now()
                                      .time_since_epoch()).count();
    put_u64(p + 20, now_ns);
    memset(p + 28, 0, rec_len - 28);  // pad: size(0) BE4 -> zeros
    uint64_t off = v->dat_size;
    if (pwrite(v->dat_fd, rec.data(), rec_len, off) != (ssize_t)rec_len) {
        (void)!ftruncate(v->dat_fd, off);
        return DP_IO;
    }
    uint8_t ie[16];
    put_u64(ie, id); put_u32(ie + 8, (uint32_t)(off / 8));
    put_u32(ie + 12, (uint32_t)TOMBSTONE);
    if (idx_append(v, ie, off) != DP_OK) return DP_IO;
    v->dat_size = off + rec_len;
    v->deleted_bytes += (uint64_t)nv.size;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        v->map.erase(id);
    }
    *out_size = (uint32_t)nv.size;
    return DP_OK;
}

// Parse a v3 record's data payload out of `rec` (without header), for a
// stored size and known data layout (needle.py _parse_body_v2 subset: we
// only need data + flags; name/mime/ttl ride behind and are skipped).
static int extract_data(const uint8_t* body, int32_t size,
                        std::vector<uint8_t>* out, uint8_t* flags) {
    if (size == 0) { out->clear(); *flags = 0; return DP_OK; }
    if (size < 5) return DP_IO;
    uint32_t dsize = get_u32(body);
    if ((int64_t)dsize + 5 > size) return DP_IO;
    out->assign(body + 4, body + 4 + dsize);
    *flags = body[4 + dsize];
    return DP_OK;
}

static int vol_read(Volume* v, uint64_t id, uint32_t cookie,
                    std::vector<uint8_t>* out) {
    NeedleVal nv;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it == v->map.end()) return DP_NOT_FOUND;
        nv = it->second;
        if (nv.size < 0) return DP_DELETED;
    }
    uint64_t rec_len = actual_size(nv.size);
    std::vector<uint8_t> rec(rec_len);
    ssize_t got = pread(v->dat_fd, rec.data(), rec_len, nv.offset);
    if (got != (ssize_t)rec_len) return DP_IO;
    const uint8_t* p = rec.data();
    if (get_u32(p) != cookie) return DP_COOKIE;
    if (get_u64(p + 4) != id) return DP_IO;
    int32_t size = (int32_t)get_u32(p + 12);
    if (size != nv.size) return DP_IO;
    uint8_t flags = 0;
    std::vector<uint8_t> data;
    int rc = extract_data(p + 16, size, &data, &flags);
    if (rc != DP_OK) return rc;
    // integrity: stored masked crc must match recomputed (needle.py)
    uint32_t stored = get_u32(p + 16 + size);
    if (stored != masked_crc(crc32c(data.data(), data.size())))
        return DP_CRC;
    if (flags & FLAG_IS_COMPRESSED) {
        // HTTP-written compressible objects are stored gzipped; the frame
        // protocol has no encoding slot, so serve the original bytes
        std::vector<uint8_t> plain(data.size() * 4 + 64);
        z_stream zs{};
        if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return DP_IO;
        zs.next_in = data.data();
        zs.avail_in = (uInt)data.size();
        size_t produced = 0;
        int zrc;
        do {
            if (produced == plain.size()) plain.resize(plain.size() * 2);
            zs.next_out = plain.data() + produced;
            zs.avail_out = (uInt)(plain.size() - produced);
            zrc = inflate(&zs, Z_NO_FLUSH);
            produced = plain.size() - zs.avail_out;
        } while (zrc == Z_OK);
        inflateEnd(&zs);
        if (zrc != Z_STREAM_END) return DP_IO;
        plain.resize(produced);
        *out = std::move(plain);
    } else {
        *out = std::move(data);
    }
    return DP_OK;
}

// ------------------------------------------------------------- fid parse
static bool parse_fid(const std::string& fid, uint32_t* vid, uint64_t* id,
                      uint32_t* cookie) {
    size_t comma = fid.find(',');
    if (comma == std::string::npos || comma == 0) return false;
    errno = 0;
    *vid = (uint32_t)strtoul(fid.c_str(), nullptr, 10);
    std::string hexs = fid.substr(comma + 1);
    if (hexs.size() <= 8) return false;
    if (hexs.size() % 2) hexs = "0" + hexs;
    size_t nb = hexs.size() / 2;
    if (nb > 12) return false;
    uint8_t raw[12] = {0};
    for (size_t i = 0; i < nb; i++) {
        auto nib = [](char c) -> int {
            if (c >= '0' && c <= '9') return c - '0';
            if (c >= 'a' && c <= 'f') return c - 'a' + 10;
            if (c >= 'A' && c <= 'F') return c - 'A' + 10;
            return -1;
        };
        int hi = nib(hexs[2 * i]), lo = nib(hexs[2 * i + 1]);
        if (hi < 0 || lo < 0) return false;
        raw[12 - nb + i] = (uint8_t)((hi << 4) | lo);
    }
    *id = get_u64(raw);
    *cookie = get_u32(raw + 8);
    return true;
}

// ------------------------------------------------------------- framing
static bool recv_exact(int fd, uint8_t* buf, size_t n) {
    while (n) {
        ssize_t got = recv(fd, buf, n, 0);
        if (got <= 0) return false;
        buf += got; n -= (size_t)got;
    }
    return true;
}

static bool send_all(int fd, const uint8_t* buf, size_t n) {
    while (n) {
        ssize_t put = send(fd, buf, n, MSG_NOSIGNAL);
        if (put <= 0) return false;
        buf += put; n -= (size_t)put;
    }
    return true;
}

static bool send_frame(int fd, uint8_t status, const uint8_t* payload,
                       uint32_t n) {
    std::vector<uint8_t> hdr(5);
    hdr[0] = status;
    put_u32(hdr.data() + 1, n);
    if (!send_all(fd, hdr.data(), 5)) return false;
    return n == 0 || send_all(fd, payload, n);
}

static void serve_conn(Server* s, int fd,
                       std::shared_ptr<std::atomic<bool>> done) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    std::vector<uint8_t> body;
    for (;;) {
        uint8_t op;
        if (!recv_exact(fd, &op, 1)) break;
        uint8_t klen_b[2];
        if (!recv_exact(fd, klen_b, 2)) break;
        uint16_t klen = get_u16(klen_b);
        std::string key(klen, '\0');
        if (klen && !recv_exact(fd, (uint8_t*)key.data(), klen)) break;
        uint8_t blen_b[4];
        if (!recv_exact(fd, blen_b, 4)) break;
        uint32_t blen = get_u32(blen_b);
        if (blen > (1u << 30)) break;  // 1GB sanity cap
        body.resize(blen);
        if (blen && !recv_exact(fd, body.data(), blen)) break;

        uint32_t vid, cookie; uint64_t id;
        int rc = DP_BAD_REQ;
        uint32_t out_size = 0;
        std::vector<uint8_t> out;
        if (op == 'W') s->frames_w++;
        else if (op == 'R') s->frames_r++;
        else if (op == 'D') s->frames_d++;
        if (parse_fid(key, &vid, &id, &cookie)) {
            VolumeRef v = find_volume(s, vid);
            if (v == nullptr) {
                rc = DP_NO_VOLUME;
            } else if (op == 'W') {
                rc = v->tcp_writable
                         ? vol_write(v.get(), id, cookie, body.data(), blen,
                                     &out_size)
                         : DP_TCP_FORBIDDEN;
            } else if (op == 'R') {
                rc = vol_read(v.get(), id, cookie, &out);
            } else if (op == 'D') {
                rc = v->tcp_writable
                         ? vol_delete(v.get(), id, cookie, &out_size)
                         : DP_TCP_FORBIDDEN;
            }
        }
        bool ok;
        if (rc == DP_OK && op == 'R') {
            ok = send_frame(fd, 0, out.data(), (uint32_t)out.size());
        } else if (rc == DP_OK) {
            uint8_t sz[4];
            put_u32(sz, out_size);
            ok = send_frame(fd, 0, sz, 4);
        } else {
            const char* msg = dp_strerror(rc);
            ok = send_frame(fd, 1, (const uint8_t*)msg,
                            (uint32_t)strlen(msg));
        }
        if (!ok) break;
    }
    close(fd);
    {
        std::lock_guard<std::mutex> g(s->conn_mu);
        s->conns.erase(fd);
    }
    done->store(true);
}

static void accept_loop(Server* s) {
    for (;;) {
        int fd = accept(s->listen_fd, nullptr, nullptr);
        if (fd < 0) {
            if (s->stopping) return;
            if (errno == EINTR) continue;
            return;
        }
        {
            std::lock_guard<std::mutex> g(s->conn_mu);
            // reap finished connection threads so the registry stays
            // bounded by the number of LIVE connections
            for (auto it = s->conn_threads.begin();
                 it != s->conn_threads.end();) {
                if (it->done->load()) {
                    it->t.join();
                    it = s->conn_threads.erase(it);
                } else {
                    ++it;
                }
            }
            s->conns.insert(fd);
            auto done = std::make_shared<std::atomic<bool>>(false);
            s->conn_threads.push_back(
                Server::ConnThread{std::thread(serve_conn, s, fd, done),
                                   done});
        }
    }
}

}  // namespace

// ================================================================ C API
extern "C" {

void* dp_start(const char* host, int port) {
    static std::once_flag once;
    std::call_once(once, [] {
        crc_init();
#if defined(__x86_64__)
        g_hw_crc = has_sse42();
#endif
    });
    if (port < 0) {
        // engine-only mode: no TCP listener at all (whitelist-guarded
        // servers — the plane has no whitelist slot, and the Python TCP
        // plane likewise refuses non-whitelisted connections outright,
        // reads included).  The C API keeps serving the HTTP funnel.
        Server* s = new Server();
        s->listen_fd = -1;
        s->port = 0;
        return s;
    }
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = host && *host ? inet_addr(host) : INADDR_ANY;
    if (bind(fd, (sockaddr*)&addr, sizeof addr) != 0 ||
        listen(fd, 128) != 0) {
        close(fd);
        return nullptr;
    }
    socklen_t alen = sizeof addr;
    getsockname(fd, (sockaddr*)&addr, &alen);
    Server* s = new Server();
    s->listen_fd = fd;
    s->port = ntohs(addr.sin_port);
    s->accept_thread = std::thread(accept_loop, s);
    return s;
}

int dp_port(void* h) { return ((Server*)h)->port; }

int dp_add_volume(void* h, unsigned vid, const char* dat_path,
                  const char* idx_path, int read_only, int tcp_writable) {
    Server* s = (Server*)h;
    auto v = std::make_shared<Volume>();
    v->read_only = read_only != 0;
    v->tcp_writable = tcp_writable != 0;
    v->dat_fd = open(dat_path, read_only ? O_RDONLY : O_RDWR);
    if (v->dat_fd < 0) return DP_IO;
    v->idx_fd = open(idx_path, O_RDWR | O_CREAT | O_APPEND, 0644);
    if (v->idx_fd < 0) return DP_IO;
    struct stat st;
    fstat(v->dat_fd, &st);
    v->dat_size = (uint64_t)st.st_size;
    // build the map from the idx (WalkIndexFile replay semantics)
    struct stat ist;
    fstat(v->idx_fd, &ist);
    uint64_t n = (uint64_t)ist.st_size / 16;
    // drop a torn (16-misaligned) tail before appending after it — the
    // Python open path truncates the same way
    if ((uint64_t)ist.st_size != n * 16)
        (void)!ftruncate(v->idx_fd, (off_t)(n * 16));
    v->idx_size = n * 16;
    std::vector<uint8_t> buf(1 << 20);
    uint64_t done = 0;
    while (done < n) {
        uint64_t batch = std::min<uint64_t>(buf.size() / 16, n - done);
        ssize_t got = pread(v->idx_fd, buf.data(), batch * 16, done * 16);
        if (got != (ssize_t)(batch * 16)) break;
        for (uint64_t i = 0; i < batch; i++) {
            const uint8_t* e = buf.data() + i * 16;
            uint64_t key = get_u64(e);
            uint64_t off = (uint64_t)get_u32(e + 8) * 8;
            int32_t size = (int32_t)get_u32(e + 12);
            if (key > v->max_key) v->max_key = key;
            auto old = v->map.find(key);
            if (old != v->map.end() && old->second.size >= 0)
                v->deleted_bytes += (uint64_t)old->second.size;
            if (off != 0 && size >= 0)
                v->map[key] = NeedleVal{off, size};
            else
                v->map.erase(key);
        }
        done += batch;
    }
    VolumeRef old;
    {
        std::lock_guard<std::mutex> g(s->vol_mu);
        auto it = s->volumes.find(vid);
        if (it != s->volumes.end()) old = it->second;
        s->volumes[vid] = v;
    }
    if (old) {  // drain + retire the replaced instance
        std::lock_guard<std::mutex> wg(old->write_mu);
        old->retired = true;
    }
    return DP_OK;
}

int dp_remove_volume(void* h, unsigned vid) {
    Server* s = (Server*)h;
    VolumeRef v;
    {
        std::lock_guard<std::mutex> g(s->vol_mu);
        auto it = s->volumes.find(vid);
        if (it == s->volumes.end()) return DP_NO_VOLUME;
        v = it->second;
        s->volumes.erase(it);
    }
    // drain the in-flight writer (if any) and fence later ones: once
    // retired is set under write_mu, no further append can touch the
    // files, so the Python side may reopen them safely.  In-flight
    // READERS hold a shared_ptr; the fds close when the last one drops.
    std::lock_guard<std::mutex> wg(v->write_mu);
    v->retired = true;
    return DP_OK;
}

int dp_write(void* h, unsigned vid, unsigned long long id, unsigned cookie,
             const unsigned char* data, unsigned len, unsigned* out_size) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    return vol_write(v.get(), id, cookie, data, len, out_size);
}

// Append a record the caller serialized (rich needles from the HTTP
// plane: name/mime/flags/cipher ride inside `rec`).  The plane stays the
// single writer — same lock, same idx append, same map update.
int dp_append(void* h, unsigned vid, unsigned long long id, unsigned cookie,
              const unsigned char* rec, unsigned long long rec_len,
              int size) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    if (v->read_only) return DP_READONLY;
    std::lock_guard<std::mutex> g(v->write_mu);
    if (v->retired) return DP_NO_VOLUME;
    if (v->dat_size + rec_len > MAX_VOLUME_BYTES) return DP_FULL;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it != v->map.end() && it->second.size >= 0) {
            uint8_t hdr[4];
            if (pread(v->dat_fd, hdr, 4, it->second.offset) == 4 &&
                get_u32(hdr) != cookie)
                return DP_COOKIE;
        }
    }
    uint64_t off = v->dat_size;
    if (pwrite(v->dat_fd, rec, rec_len, off) != (ssize_t)rec_len) {
        (void)!ftruncate(v->dat_fd, off);
        return DP_IO;
    }
    uint8_t ie[16];
    put_u64(ie, id); put_u32(ie + 8, (uint32_t)(off / 8));
    put_u32(ie + 12, (uint32_t)size);
    if (idx_append(v.get(), ie, off) != DP_OK) return DP_IO;
    v->dat_size = off + rec_len;
    if (id > v->max_key) v->max_key = id;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it != v->map.end() && it->second.size >= 0)
            v->deleted_bytes += (uint64_t)it->second.size;
        if (size >= 0)
            v->map[id] = NeedleVal{off, size};
        else
            v->map.erase(id);
    }
    return DP_OK;
}

// Whole stored record back to Python (HTTP reads need name/mime/flags);
// cookie is checked here (unless check_cookie=0, the Python
// read_needle(cookie=None) path) so a miss never ships the blob.
int dp_read_record(void* h, unsigned vid, unsigned long long id,
                   unsigned cookie, int check_cookie, unsigned char** out,
                   unsigned long long* out_len, int* out_size) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    NeedleVal nv;
    {
        std::lock_guard<std::mutex> m(v->map_mu);
        auto it = v->map.find(id);
        if (it == v->map.end()) return DP_NOT_FOUND;
        nv = it->second;
        if (nv.size < 0) return DP_DELETED;
    }
    uint64_t rec_len = actual_size(nv.size);
    unsigned char* buf = (unsigned char*)malloc(rec_len);
    if (pread(v->dat_fd, buf, rec_len, nv.offset) != (ssize_t)rec_len) {
        free(buf);
        return DP_IO;
    }
    if (check_cookie && get_u32(buf) != cookie) {
        free(buf);
        return DP_COOKIE;
    }
    if (get_u64(buf + 4) != id) { free(buf); return DP_IO; }
    *out = buf;
    *out_len = rec_len;
    *out_size = nv.size;
    return DP_OK;
}

int dp_delete(void* h, unsigned vid, unsigned long long id, unsigned cookie,
              unsigned* out_size) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    return vol_delete(v.get(), id, cookie, out_size);
}

// out buffer is malloc'd; caller frees with dp_free
int dp_read(void* h, unsigned vid, unsigned long long id, unsigned cookie,
            unsigned char** out, unsigned* out_len) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    std::vector<uint8_t> data;
    int rc = vol_read(v.get(), id, cookie, &data);
    if (rc != DP_OK) return rc;
    *out = (unsigned char*)malloc(data.size() ? data.size() : 1);
    memcpy(*out, data.data(), data.size());
    *out_len = (unsigned)data.size();
    return DP_OK;
}

void dp_free(void* p) { free(p); }

// W, R and D frames the TCP listener has served so far
void dp_frames(void* h, unsigned long long* w, unsigned long long* r,
               unsigned long long* d) {
    Server* s = (Server*)h;
    *w = s->frames_w.load();
    *r = s->frames_r.load();
    *d = s->frames_d.load();
}

int dp_stat(void* h, unsigned vid, unsigned long long* dat_size,
            unsigned long long* file_count,
            unsigned long long* max_file_key,
            unsigned long long* deleted_bytes,
            unsigned long long* sync_passes) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    *dat_size = v->dat_size;
    *max_file_key = v->max_key;
    *deleted_bytes = v->deleted_bytes;
    {
        std::lock_guard<std::mutex> s(v->sync_mu);
        *sync_passes = v->sync_passes;
    }
    std::lock_guard<std::mutex> m(v->map_mu);
    *file_count = v->map.size();
    return DP_OK;
}

int dp_sync(void* h, unsigned vid) {
    VolumeRef v = find_volume((Server*)h, vid);
    if (!v) return DP_NO_VOLUME;
    // group commit: concurrent durable writers share one fsync pass, and
    // appends keep flowing while it runs (the VolumeRef keeps fds alive
    // across a concurrent retire)
    return vol_group_sync(v.get());
}

void dp_stop(void* h) {
    Server* s = (Server*)h;
    s->stopping = true;
    if (s->listen_fd >= 0) {
        shutdown(s->listen_fd, SHUT_RDWR);
        close(s->listen_fd);
    }
    {
        std::lock_guard<std::mutex> g(s->conn_mu);
        for (int fd : s->conns) shutdown(fd, SHUT_RDWR);
    }
    if (s->accept_thread.joinable()) s->accept_thread.join();
    // a connection accepted in the shutdown window is only registered
    // AFTER the first pass above; with the accept thread joined the
    // registry is final, so one more pass closes any straggler
    {
        std::lock_guard<std::mutex> g(s->conn_mu);
        for (int fd : s->conns) shutdown(fd, SHUT_RDWR);
    }
    std::vector<Server::ConnThread> threads;
    {
        std::lock_guard<std::mutex> g(s->conn_mu);
        threads.swap(s->conn_threads);
    }
    for (auto& ct : threads)
        if (ct.t.joinable()) ct.t.join();
    {
        std::lock_guard<std::mutex> g(s->vol_mu);
        s->volumes.clear();  // shared_ptr closes fds on release
    }
    // the Server shell itself is intentionally NOT freed: a Python
    // thread that raced stop() may still hold the handle, and dp_* on a
    // drained Server safely answers DP_NO_VOLUME (a few hundred bytes
    // leak once per plane, at process teardown in practice)
}

}  // extern "C"
