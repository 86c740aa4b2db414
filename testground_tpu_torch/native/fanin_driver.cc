// tg-fanin-driver — native mini-client fleet for tools/bench_sync_fanin.py.
//
// One driver process owns one worker-share of the bench's concurrent
// clients and runs them through the fan-in phases (connect storm →
// signal flood → barrier storm → pubsub fanout) in a single epoll loop,
// one outstanding request per client, latency stamped send→reply — the
// native twin of the bench's selector-multiplexed Python workers.
//
// Why it exists: BENCH_SYNC_r01 measured the PYTHON workers as the
// pipeline ceiling on a small box (one worker alone tops out near 50k
// round-trips/s, so at 10k clients the harness — not the server — sets
// flood p50). A server rewrite cannot be judged through a harness that
// saturates first; this driver costs ~1-2 µs/op and hands the bottleneck
// back to the server under test. The Python workers remain the fallback
// when no C++ toolchain exists (bench --driver python).
//
// Protocol with the parent (tools/bench_sync_fanin.py):
//   stdin:  one "go\n" line per phase (connect, flood, storm, pubsub)
//   stdout: one JSON result line per phase:
//     {"phase": "connect", "connected": N, "wall": S, "errors": [...]}
//     {"phase": "flood",   "wall": S, "lats_ms": [...], "errors": [...]}
//     {"phase": "storm",   "wall": S, "lats_ms": [...], "errors": [...]}
//     {"phase": "pubsub",  "wall": S, "delivered": N, "errors": [...]}
//       (pubsub runs only under --pub-subs > 0; otherwise it reports
//        {"phase": "pubsub", "skipped": true})
// A phase that blows its --timeout records the failure in "errors" and
// still answers — a dead rung is a result, not a crash.
//
// Build: g++ -O2 -std=c++17 -o tg-fanin-driver fanin_driver.cc
// (built+cached by testground_tpu_torch/native/syncsvc.py build_fanin_driver).

#include <arpa/inet.h>
#include <cerrno>
#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

double now_secs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

struct Cl {
  int fd = -1;
  int sent = 0;        // requests sent this phase
  double t_sent = 0;   // stamp of the in-flight request
  std::string rbuf;
  bool active = false;
};

int g_ep = -1;
std::vector<Cl> g_cl;

void ep_mod(int fd, uint32_t events, int idx) {
  struct epoll_event ev{};
  ev.events = events;
  ev.data.u32 = (uint32_t)idx;
  epoll_ctl(g_ep, EPOLL_CTL_MOD, fd, &ev);
}

void ep_add(int fd, uint32_t events, int idx) {
  struct epoll_event ev{};
  ev.events = events;
  ev.data.u32 = (uint32_t)idx;
  epoll_ctl(g_ep, EPOLL_CTL_ADD, fd, &ev);
}

bool send_all(int fd, const std::string& data, double deadline,
              std::vector<std::string>& errors) {
  // requests are <200B: a transient full buffer drains with a bounded
  // blocking retry, mirroring the Python workers' _send_line fallback
  size_t off = 0;
  while (off < data.size()) {
    ssize_t n = send(fd, data.data() + off, data.size() - off, MSG_NOSIGNAL);
    if (n > 0) {
      off += (size_t)n;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (now_secs() > deadline) {
        errors.push_back("send stalled past deadline");
        return false;
      }
      struct timespec ts {0, 2000000};  // 2ms
      nanosleep(&ts, nullptr);
      continue;
    }
    errors.push_back(std::string("send: ") + strerror(errno));
    return false;
  }
  return true;
}

void json_errors(std::string& out, const std::vector<std::string>& errors) {
  out += "\"errors\": [";
  size_t cap = errors.size() < 20 ? errors.size() : 20;
  for (size_t i = 0; i < cap; i++) {
    if (i) out += ", ";
    out += '"';
    for (char c : errors[i]) {
      if (c == '"' || c == '\\') out += '\\';
      if ((unsigned char)c >= 0x20) out += c;
    }
    out += '"';
  }
  out += "]";
}

void emit(const std::string& body) {
  printf("{%s}\n", body.c_str());
  fflush(stdout);
}

void emit_lats(std::string& out, const std::vector<double>& lats) {
  out += "\"lats_ms\": [";
  char buf[32];
  for (size_t i = 0; i < lats.size(); i++) {
    snprintf(buf, sizeof buf, i ? ", %.3f" : "%.3f", lats[i]);
    out += buf;
  }
  out += "]";
}

// ------------------------------------------------------------------ phases

void phase_connect(const char* host, int port, int n, int batch,
                   double timeout) {
  std::vector<std::string> errors;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, host, &addr.sin_addr);
  double t0 = now_secs(), deadline = t0 + timeout;
  int started = 0, connected = 0, inflight = 0, one = 1;
  struct epoll_event evs[512];
  while (connected + (int)errors.size() < n) {
    if (now_secs() > deadline) {
      char b[96];
      snprintf(b, sizeof b, "connect deadline with %d/%d up", connected, n);
      errors.push_back(b);
      break;
    }
    while (started < n && inflight < batch) {
      int idx = started++;
      int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
      if (fd < 0) {
        errors.push_back(std::string("socket: ") + strerror(errno));
        continue;
      }
      int rc = connect(fd, (sockaddr*)&addr, sizeof addr);
      if (rc != 0 && errno != EINPROGRESS) {
        errors.push_back(std::string("connect: ") + strerror(errno));
        close(fd);
        continue;
      }
      g_cl[idx].fd = fd;
      ep_add(fd, EPOLLOUT, idx);
      inflight++;
    }
    if (inflight == 0 && started >= n) break;
    int rc = epoll_wait(g_ep, evs, 512, 1000);
    for (int i = 0; i < rc; i++) {
      int idx = (int)evs[i].data.u32;
      Cl& c = g_cl[idx];
      int err = 0;
      socklen_t len = sizeof err;
      getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &len);
      inflight--;
      if (err) {
        char b[64];
        snprintf(b, sizeof b, "connect SO_ERROR %d", err);
        errors.push_back(b);
        epoll_ctl(g_ep, EPOLL_CTL_DEL, c.fd, nullptr);
        close(c.fd);
        c.fd = -1;
        continue;
      }
      setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
      ep_mod(c.fd, EPOLLIN, idx);
      c.active = true;
      connected++;
    }
  }
  char head[96];
  snprintf(head, sizeof head, "\"phase\": \"connect\", \"connected\": %d, "
           "\"wall\": %.3f, ", connected, now_secs() - t0);
  std::string body(head);
  json_errors(body, errors);
  emit(body);
}

// Serial request/response per client, all multiplexed on the epoll set;
// reqs[i % reqs.size()] is client i's (constant) request line.
void phase_rr(const char* name, const std::vector<std::string>& reqs,
              bool per_client_req, int ops_per_client, double timeout) {
  std::vector<std::string> errors;
  std::vector<double> lats;
  lats.reserve((size_t)ops_per_client * g_cl.size());
  double t0 = now_secs(), deadline = t0 + timeout;
  int active = 0;
  for (size_t i = 0; i < g_cl.size(); i++) {
    Cl& c = g_cl[i];
    c.sent = 0;
    if (!c.active || ops_per_client <= 0) continue;
    const std::string& req =
        per_client_req ? reqs[i % reqs.size()] : reqs[0];
    c.t_sent = now_secs();
    if (!send_all(c.fd, req, deadline, errors)) {
      c.active = false;
      continue;
    }
    c.sent = 1;
    active++;
  }
  struct epoll_event evs[512];
  char rb[65536];
  while (active > 0) {
    if (now_secs() > deadline) {
      char b[96];
      snprintf(b, sizeof b, "phase deadline with %d clients pending", active);
      errors.push_back(b);
      break;
    }
    int rc = epoll_wait(g_ep, evs, 512, 1000);
    for (int i = 0; i < rc; i++) {
      int idx = (int)evs[i].data.u32;
      Cl& c = g_cl[idx];
      if (!c.active || c.sent == 0) continue;
      ssize_t n = recv(c.fd, rb, sizeof rb, 0);
      if (n == 0 || (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
        errors.push_back(n == 0 ? "server closed connection"
                                : std::string("recv: ") + strerror(errno));
        c.active = false;
        active--;
        continue;
      }
      if (n < 0) continue;
      c.rbuf.append(rb, (size_t)n);
      size_t start = 0, nl;
      while ((nl = c.rbuf.find('\n', start)) != std::string::npos) {
        double now = now_secs();
        if (c.rbuf.find("\"error\"", start) < nl)
          errors.push_back(c.rbuf.substr(start, std::min(nl - start,
                                                         (size_t)200)));
        else
          lats.push_back((now - c.t_sent) * 1e3);
        start = nl + 1;
        if (c.sent < ops_per_client) {
          const std::string& req =
              per_client_req ? reqs[idx % reqs.size()] : reqs[0];
          c.t_sent = now_secs();
          if (!send_all(c.fd, req, deadline, errors)) {
            c.active = false;
            active--;
            break;
          }
          c.sent++;
        } else {
          active--;
          break;
        }
      }
      c.rbuf.erase(0, start);
    }
  }
  char head[64];
  snprintf(head, sizeof head, "\"phase\": \"%s\", \"wall\": %.3f, ", name,
           now_secs() - t0);
  std::string body(head);
  emit_lats(body, lats);
  body += ", ";
  json_errors(body, errors);
  emit(body);
}

void phase_pubsub(int n_subs, int n_entries, double timeout) {
  std::vector<std::string> errors;
  int usable = 0;
  for (Cl& c : g_cl)
    if (c.active) usable++;
  if (usable < n_subs + 1) n_subs = usable > 1 ? usable - 1 : 0;
  if (n_subs <= 0) {
    emit("\"phase\": \"pubsub\", \"skipped\": true, "
         "\"errors\": [\"no clients left for pubsub\"]");
    return;
  }
  double deadline = now_secs() + timeout;
  // the first n_subs active clients subscribe; the next one publishes
  int pub_idx = -1, marked = 0;
  for (size_t i = 0; i < g_cl.size(); i++) {
    if (!g_cl[i].active) continue;
    if (marked < n_subs) {
      g_cl[i].sent = 1;  // reused as "is subscriber" this phase
      send_all(g_cl[i].fd,
               "{\"id\": 1, \"op\": \"subscribe\", \"topic\": \"fanout\"}\n",
               deadline, errors);
      marked++;
    } else {
      g_cl[i].sent = 0;
      if (pub_idx < 0) pub_idx = (int)i;
    }
  }
  Cl& pub = g_cl[pub_idx];
  double t0 = now_secs();
  long delivered = 0, want = (long)n_subs * n_entries;
  int published = 0, pub_inflight = 0;
  struct epoll_event evs[512];
  char rb[262144];
  char preq[128];
  while (delivered < want || published < n_entries || pub_inflight) {
    if (now_secs() > deadline) {
      char b[96];
      snprintf(b, sizeof b, "pubsub deadline: %ld/%ld frames", delivered,
               want);
      errors.push_back(b);
      break;
    }
    if (pub_inflight == 0 && published < n_entries) {
      snprintf(preq, sizeof preq,
               "{\"id\": 2, \"op\": \"publish\", \"topic\": \"fanout\", "
               "\"payload\": {\"m\": %d}}\n", published);
      if (!send_all(pub.fd, preq, deadline, errors)) break;
      published++;
      pub_inflight = 1;
    }
    int rc = epoll_wait(g_ep, evs, 512, 200);
    for (int i = 0; i < rc; i++) {
      int idx = (int)evs[i].data.u32;
      Cl& c = g_cl[idx];
      if (!c.active) continue;
      ssize_t n = recv(c.fd, rb, sizeof rb, 0);
      if (n == 0 || (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
        errors.push_back(idx == pub_idx ? "publisher connection closed"
                                        : "sub closed");
        c.active = false;
        if (idx == pub_idx) pub_inflight = 0;
        continue;
      }
      if (n < 0) continue;
      c.rbuf.append(rb, (size_t)n);
      size_t start = 0, nl;
      while ((nl = c.rbuf.find('\n', start)) != std::string::npos) {
        if (idx == pub_idx) {
          pub_inflight = 0;
        } else if (c.rbuf.find("\"entry\"", start) < nl) {
          delivered++;
        }
        start = nl + 1;
      }
      c.rbuf.erase(0, start);
    }
  }
  char head[96];
  snprintf(head, sizeof head,
           "\"phase\": \"pubsub\", \"wall\": %.3f, \"delivered\": %ld, ",
           now_secs() - t0, delivered);
  std::string body(head);
  json_errors(body, errors);
  emit(body);
}

bool await_go() {
  char line[64];
  return fgets(line, sizeof line, stdin) != nullptr;
}

}  // namespace

int main(int argc, char** argv) {
  const char* host = "127.0.0.1";
  int port = 0, wid = 0, clients = 0, total = 0, signal_ops = 20;
  int pub_subs = 0, pub_entries = 50, batch = 200;
  double timeout = 180.0;
  for (int i = 1; i + 1 < argc; i += 2) {
    if (!strcmp(argv[i], "--host")) host = argv[i + 1];
    if (!strcmp(argv[i], "--port")) port = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--wid")) wid = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--clients")) clients = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--total")) total = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--signal-ops")) signal_ops = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--pub-subs")) pub_subs = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--pub-entries")) pub_entries = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--connect-batch")) batch = atoi(argv[i + 1]);
    if (!strcmp(argv[i], "--timeout")) timeout = atof(argv[i + 1]);
  }
  if (clients <= 0 || port == 0) {
    fprintf(stderr, "tg-fanin-driver: need --clients and --port\n");
    return 2;
  }
  if (!strcmp(host, "localhost")) host = "127.0.0.1";
  signal(SIGPIPE, SIG_IGN);
  g_ep = epoll_create1(0);
  g_cl.resize(clients);

  if (!await_go()) return 0;
  phase_connect(host, port, clients, batch, timeout);

  if (!await_go()) return 0;
  // constant per-client flood request: state flood-<wid>-<i%16>
  std::vector<std::string> reqs;
  for (int s = 0; s < 16; s++) {
    char b[128];
    snprintf(b, sizeof b,
             "{\"id\": 1, \"op\": \"signal_entry\", \"state\": "
             "\"flood-%d-%d\"}\n", wid, s);
    reqs.push_back(b);
  }
  phase_rr("flood", reqs, true, signal_ops, timeout);

  if (!await_go()) return 0;
  char storm[160];
  snprintf(storm, sizeof storm,
           "{\"id\": 1, \"op\": \"signal_and_wait\", \"state\": \"storm\", "
           "\"target\": %d, \"timeout\": %.1f}\n", total, timeout);
  phase_rr("storm", {std::string(storm)}, false, 1, timeout);

  if (!await_go()) return 0;
  if (pub_subs > 0)
    phase_pubsub(pub_subs, pub_entries, timeout);
  else
    emit("\"phase\": \"pubsub\", \"skipped\": true, \"errors\": []");

  for (Cl& c : g_cl)
    if (c.fd >= 0) close(c.fd);
  return 0;
}
