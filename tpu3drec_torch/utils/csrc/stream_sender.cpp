// stream_sender: C++ capture client for the frame-stream protocol of
// tpu3drec_torch/data/stream.py (the port's copy of native/stream_sender.cpp,
// built by tpu3drec_torch/ops/build.py::build_host into build/).
//
// Replays a pre-recorded capture blob over the v1 wire protocol to a
// listening fusion server (`serve`), as a camera rig's capture client
// would. No dependencies beyond POSIX sockets, so a bare `c++` builds it.
//
// Capture blob layout (little-endian), written by tests or a recorder:
//   magic "T3DC" | u32 nframes | u16 H | u16 W | u8 flags
//   per frame: f32 depth[H*W] | u8 rgb[H*W*3] if flags&1 |
//              f32 pose[7] (tx ty tz qx qy qz qw) if flags&2
//
// Usage: stream_sender <blob> <host> <port>

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

bool send_all(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

#pragma pack(push, 1)
struct FrameHeader {
  uint32_t frame_id;
  uint16_t h;
  uint16_t w;
  uint8_t flags;
};
#pragma pack(pop)
static_assert(sizeof(FrameHeader) == 9, "wire header must be 9 bytes");

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s <blob> <host> <port>\n", argv[0]);
    return 2;
  }
  std::FILE* f = std::fopen(argv[1], "rb");
  if (!f) {
    std::perror("open blob");
    return 1;
  }
  char magic[4];
  uint32_t nframes = 0;
  uint16_t h = 0, w = 0;
  uint8_t flags = 0;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "T3DC", 4) != 0 ||
      std::fread(&nframes, 4, 1, f) != 1 || std::fread(&h, 2, 1, f) != 1 ||
      std::fread(&w, 2, 1, f) != 1 || std::fread(&flags, 1, 1, f) != 1) {
    std::fprintf(stderr, "bad capture blob header\n");
    return 1;
  }

  struct addrinfo hints {};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (getaddrinfo(argv[2], argv[3], &hints, &res) != 0 || !res) {
    std::fprintf(stderr, "resolve failed\n");
    return 1;
  }
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    std::perror("connect");
    return 1;
  }
  freeaddrinfo(res);

  const uint32_t version = 1;
  if (!send_all(fd, "T3DR", 4) || !send_all(fd, &version, 4)) return 1;

  const size_t depth_bytes = sizeof(float) * h * w;
  const size_t rgb_bytes = (flags & 1) ? size_t(3) * h * w : 0;
  const size_t pose_bytes = (flags & 2) ? sizeof(float) * 7 : 0;
  std::vector<char> body(depth_bytes + rgb_bytes + pose_bytes);

  for (uint32_t i = 0; i < nframes; ++i) {
    if (std::fread(body.data(), 1, body.size(), f) != body.size()) {
      std::fprintf(stderr, "blob truncated at frame %u\n", i);
      return 1;
    }
    FrameHeader hdr{i, h, w, flags};
    if (!send_all(fd, &hdr, sizeof hdr) ||
        !send_all(fd, body.data(), body.size())) {
      std::fprintf(stderr, "send failed at frame %u\n", i);
      return 1;
    }
  }
  FrameHeader end{0xFFFFFFFFu, 0, 0, 0};
  if (!send_all(fd, &end, sizeof end)) return 1;
  ::close(fd);
  std::fclose(f);
  std::printf("sent %u frames (%ux%u, flags=%u)\n", nframes, w, h, flags);
  return 0;
}
