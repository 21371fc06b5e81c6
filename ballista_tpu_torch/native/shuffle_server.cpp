// Native shuffle data-plane server for ballista-tpu.
//
// The role the reference's Arrow Flight service plays for shuffle fetch
// (reference: rust/executor/src/flight_service.rs:193-228 FetchPartition).
// Speaks the exact protocol of ballista_tpu/distributed/dataplane.py:
//
//   request:  u32_be length | ballista_tpu.Action protobuf
//   response: u8 status (0 ok / 1 err) | u64_be length | payload
//
// The Action message is decoded with a minimal hand-rolled protobuf-wire
// reader (only the fetch_partition arm is needed), so the binary has zero
// dependencies beyond libc. Thread-per-connection; serves files from the
// executor work_dir (work_dir/{job}/{stage}/{partition}/data.arrow).
//
// Usage: shuffle_server <port> <work_dir>
// Also exposes a C API (start_shuffle_server) for embedding via ctypes.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <string>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// minimal protobuf wire decoding (varint + length-delimited)
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  bool bytes(uint64_t len, const uint8_t** out) {
    if (static_cast<uint64_t>(end - p) < len) {
      ok = false;
      return false;
    }
    *out = p;
    p += len;
    return true;
  }

  void skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: {
        uint64_t n = varint();
        const uint8_t* dummy;
        bytes(n, &dummy);
        break;
      }
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

struct FetchRequest {
  std::string job_id;
  uint32_t stage_id = 0;
  uint32_t partition_id = 0;
  bool is_shuffle = false;
  uint32_t output_partition = 0;
  bool valid = false;
};

// PartitionId { string job_id = 1; uint32 stage_id = 2; uint32 partition_id = 3; }
bool decode_partition_id(const uint8_t* buf, size_t len, FetchRequest* out) {
  Reader rr{buf, buf + len};
  while (rr.ok && rr.p < rr.end) {
    uint64_t t2 = rr.varint();
    uint32_t f2 = static_cast<uint32_t>(t2 >> 3);
    uint32_t w2 = static_cast<uint32_t>(t2 & 7);
    if (f2 == 1 && w2 == 2) {
      uint64_t sn = rr.varint();
      const uint8_t* sp;
      if (!rr.bytes(sn, &sp)) break;
      out->job_id.assign(reinterpret_cast<const char*>(sp), sn);
    } else if (f2 == 2 && w2 == 0) {
      out->stage_id = static_cast<uint32_t>(rr.varint());
    } else if (f2 == 3 && w2 == 0) {
      out->partition_id = static_cast<uint32_t>(rr.varint());
    } else {
      rr.skip(w2);
    }
  }
  return rr.ok && !out->job_id.empty();
}

// Action { oneof { ExecutePartition execute_partition = 1;
//                  PartitionId fetch_partition = 2; string sql = 3;
//                  FetchShufflePartition fetch_shuffle = 4; } }
// FetchShufflePartition { PartitionId producer = 1;
//                         uint32 output_partition = 2; }
FetchRequest decode_action(const uint8_t* buf, size_t len) {
  FetchRequest out;
  Reader r{buf, buf + len};
  while (r.ok && r.p < r.end) {
    uint64_t tag = r.varint();
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wt = static_cast<uint32_t>(tag & 7);
    if (field == 2 && wt == 2) {  // fetch_partition submessage
      uint64_t n = r.varint();
      const uint8_t* sub;
      if (!r.bytes(n, &sub)) break;
      out.valid = decode_partition_id(sub, n, &out);
    } else if (field == 4 && wt == 2) {  // fetch_shuffle submessage
      uint64_t n = r.varint();
      const uint8_t* sub;
      if (!r.bytes(n, &sub)) break;
      Reader rr{sub, sub + n};
      out.is_shuffle = true;
      bool got_producer = false;
      while (rr.ok && rr.p < rr.end) {
        uint64_t t2 = rr.varint();
        uint32_t f2 = static_cast<uint32_t>(t2 >> 3);
        uint32_t w2 = static_cast<uint32_t>(t2 & 7);
        if (f2 == 1 && w2 == 2) {
          uint64_t sn = rr.varint();
          const uint8_t* sp;
          if (!rr.bytes(sn, &sp)) break;
          got_producer = decode_partition_id(sp, sn, &out);
        } else if (f2 == 2 && w2 == 0) {
          out.output_partition = static_cast<uint32_t>(rr.varint());
        } else {
          rr.skip(w2);
        }
      }
      out.valid = rr.ok && got_producer;
    } else {
      r.skip(wt);
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// socket plumbing
// ---------------------------------------------------------------------------

bool recv_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t k = recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool send_all(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t k = send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

void send_response(int fd, uint8_t status, const void* body, uint64_t len) {
  uint8_t hdr[9];
  hdr[0] = status;
  for (int i = 0; i < 8; ++i)
    hdr[1 + i] = static_cast<uint8_t>((len >> (8 * (7 - i))) & 0xff);
  if (send_all(fd, hdr, 9) && len > 0) send_all(fd, body, len);
}

void send_error(int fd, const std::string& msg) {
  send_response(fd, 1, msg.data(), msg.size());
}

struct ConnArgs {
  int fd;
  std::string work_dir;
};

bool path_component_ok(const std::string& s) {
  if (s.empty() || s.size() > 128) return false;
  for (char c : s)
    if (!isalnum(static_cast<unsigned char>(c)) && c != '-' && c != '_')
      return false;
  return true;
}

void* handle_conn(void* argp) {
  auto* args = static_cast<ConnArgs*>(argp);
  int fd = args->fd;
  uint8_t len4[4];
  if (recv_exact(fd, len4, 4)) {
    uint32_t len = (uint32_t(len4[0]) << 24) | (uint32_t(len4[1]) << 16) |
                   (uint32_t(len4[2]) << 8) | uint32_t(len4[3]);
    if (len > 0 && len < (1u << 20)) {
      std::string body(len, 0);
      if (recv_exact(fd, body.data(), len)) {
        FetchRequest req =
            decode_action(reinterpret_cast<const uint8_t*>(body.data()), len);
        if (!req.valid) {
          send_error(fd, "unsupported or malformed data-plane action");
        } else if (!path_component_ok(req.job_id)) {
          send_error(fd, "bad job id");
        } else {
          char path[512];
          if (req.is_shuffle) {
            snprintf(path, sizeof path, "%s/%s/%u/%u/shuffle-%u.arrow",
                     args->work_dir.c_str(), req.job_id.c_str(),
                     req.stage_id, req.partition_id, req.output_partition);
          } else {
            snprintf(path, sizeof path, "%s/%s/%u/%u/data.arrow",
                     args->work_dir.c_str(), req.job_id.c_str(), req.stage_id,
                     req.partition_id);
          }
          FILE* f = fopen(path, "rb");
          if (!f) {
            send_error(fd, std::string("no such partition: ") + path);
          } else {
            fseek(f, 0, SEEK_END);
            long size = ftell(f);
            fseek(f, 0, SEEK_SET);
            std::string data(static_cast<size_t>(size), 0);
            if (fread(data.data(), 1, data.size(), f) == data.size()) {
              send_response(fd, 0, data.data(), data.size());
            } else {
              send_error(fd, "partition read failed");
            }
            fclose(f);
          }
        }
      }
    }
  }
  close(fd);
  delete args;
  return nullptr;
}

struct ServerArgs {
  int listen_fd;
  std::string work_dir;
};

void* accept_loop(void* argp) {
  auto* s = static_cast<ServerArgs*>(argp);
  for (;;) {
    int fd = accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      break;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    auto* ca = new ConnArgs{fd, s->work_dir};
    pthread_t t;
    pthread_create(&t, nullptr, handle_conn, ca);
    pthread_detach(t);
  }
  delete s;
  return nullptr;
}

}  // namespace

extern "C" {

// Starts the server on a background thread bound to ``bind_host`` (numeric
// IPv4, "localhost", or ""/"0.0.0.0" for INADDR_ANY — matching the Python
// DataPlaneServer's bind semantics so loopback-only deployments stay
// loopback-only). Returns the bound port (>0) or a negative errno. port=0
// picks an ephemeral port.
int start_shuffle_server_bind(int port, const char* work_dir,
                              const char* bind_host) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  if (bind_host != nullptr && bind_host[0] != '\0' &&
      strcmp(bind_host, "0.0.0.0") != 0) {
    if (strcmp(bind_host, "localhost") == 0) {
      addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    } else if (inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
      close(fd);
      return -EINVAL;
    }
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) < 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  if (listen(fd, 128) < 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  socklen_t alen = sizeof addr;
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  auto* sa = new ServerArgs{fd, work_dir};
  pthread_t t;
  pthread_create(&t, nullptr, accept_loop, sa);
  pthread_detach(t);
  return ntohs(addr.sin_port);
}

int start_shuffle_server(int port, const char* work_dir) {
  return start_shuffle_server_bind(port, work_dir, nullptr);
}

}  // extern "C"

#ifndef NO_MAIN
#include <sys/prctl.h>
#include <csignal>

int main(int argc, char** argv) {
  if (argc != 3 && argc != 4) {
    fprintf(stderr, "usage: %s <port> <work_dir> [bind_host]\n", argv[0]);
    return 2;
  }
  // die with the spawning executor: an abnormally-killed parent must not
  // orphan a daemon holding the configured port (opt out for standalone
  // runs with SHUFFLE_SERVER_PDEATHSIG=0)
  const bool tie_to_parent = [] {
    const char* pd = getenv("SHUFFLE_SERVER_PDEATHSIG");
    return pd == nullptr || strcmp(pd, "0") != 0;
  }();
  if (tie_to_parent) {
    prctl(PR_SET_PDEATHSIG, SIGTERM);
  }
  int port = start_shuffle_server_bind(atoi(argv[1]), argv[2],
                                       argc == 4 ? argv[3] : nullptr);
  if (port < 0) {
    fprintf(stderr, "bind failed: %s\n", strerror(-port));
    return 1;
  }
  printf("ballista-tpu shuffle server on port %d serving %s\n", port, argv[2]);
  fflush(stdout);
  if (tie_to_parent) {
    // PDEATHSIG can be inert under some sandboxes/kernels, so also poll.
    // The EXPECTED parent pid comes from the spawner
    // (SHUFFLE_SERVER_PARENT_PID): comparing against a pid captured
    // here would race a parent that died before we got scheduled —
    // we'd record the reaper and never notice. Reparenting (getppid
    // differs from the expected pid, or init) means the executor died.
    pid_t expected = getppid();
    const char* pp = getenv("SHUFFLE_SERVER_PARENT_PID");
    if (pp != nullptr && atoi(pp) > 0) expected = (pid_t)atoi(pp);
    for (;;) {
      pid_t now = getppid();
      if (now != expected || now == 1) return 0;
      sleep(2);
    }
  }
  pause();
  return 0;
}
#endif  // NO_MAIN
