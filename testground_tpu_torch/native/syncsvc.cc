// tg-syncsvc — native sync service for the local:exec runner.
//
// The runtime analog of the reference's sync-service container (Go +
// Redis, pkg/runner/local_common.go:77-104): sharded epoll event loops
// serving the framework's newline-delimited-JSON protocol
// (testground_tpu_torch/sync/server.py is the behavioral spec):
//
//   request:  {"id": N, "op": <op>, ...args}\n
//   reply:    {"id": N, ...result}\n             exactly one, except
//   subscribe streams {"id": N, "entry": <raw>, "seq": i} frames.
//
// Ops: signal_entry(state[, token]), counter(state), barrier(state,
// target[, timeout]), signal_and_wait(state, target[, timeout][,
// token]), publish(topic, payload[, token]), subscribe(topic), plus the
// liveness/identity plane (docs/CROSSHOST.md, spec'd by server.py):
// ping (pong + boot id), hello (instance identity; abnormal disconnect
// publishes an eviction event to its events_topic), bye (clean close),
// sync_stats (the wire-versioned stats plane, v2: v1 occupancy fields
// conns/waiters/subs/boot plus counter-level per-op/conn-churn/barrier-
// lifecycle/pubsub/dedup blocks — docs/INSTANCE_PROTOCOL.md §4.2; this
// server stays at counter level, histograms are python-server-only).
// `token` is an idempotency key: re-sent mutations from a reconnecting
// client answer with the original seq instead of mutating twice.
//
// Architecture (the 10k fan-in rewrite, docs/CROSSHOST.md "Server
// architecture"). The r1 bench measured the previous single-poll()
// design serializing at 10k clients — every wake rescanned a 10k-entry
// pollfd array and every signal rescanned the whole flat waiter list
// (O(W²) under a width-W barrier storm). Now:
//
// - --shards N event-loop THREADS (default auto: min(4, cores)), one
//   epoll set per shard; the listener is registered EPOLLEXCLUSIVE in
//   every set so the kernel fans accepted connections out across
//   shards. Connections are owned by their accepting shard; all
//   coordination state (counters/topics/waiters/tokens/stats) is
//   shared under one mutex taken ONCE PER DRAIN, not per op.
// - each wake DRAINS every ready connection first (no lock), then
//   applies the whole batch of decoded ops in one locked pass, then
//   runs ONE coalesced release pass: waiters are indexed per state
//   with a min-target watermark, so a signal storm costs O(1) per
//   signal until a barrier is actually satisfiable, and a satisfied
//   barrier fans out all W replies in one sweep (batched release).
// - the request hot path is allocation-free: fields are parsed as
//   string_views over the connection's read buffer, and replies are
//   appended straight into a flat per-connection write buffer flushed
//   once per drain — many frames, one send().
// - a reader whose write-buffer backlog trips --max-wbuf (default
//   16 MiB) has stopped reading and is shed (slow-reader backpressure)
//   rather than wedging memory or fairness for other peers. Cross-
//   shard replies (barrier releases, pubsub fanout) ride per-shard
//   inboxes + an eventfd wake, tagged with a connection generation so
//   a recycled fd never receives a dead peer's frames.
// - publish payloads are NEVER parsed: the raw JSON value text is
//   stored and echoed verbatim into subscribe frames;
// - stdout handshake: "LISTENING <port>" once bound (the runner reads
//   this to learn an ephemeral port);
// - --host picks the bind address (default loopback; 0.0.0.0 makes the
//   service a network citizen other hosts can dial); --idle-timeout S
//   evicts connections that sent nothing (not even a heartbeat ping)
//   for S seconds, so a SIGSTOPped or half-open peer releases its
//   parked waiters instead of leaking occupancy forever.
//
// Build: g++ -O2 -std=c++17 -pthread -o tg-syncsvc syncsvc.cc
// (testground_tpu_torch/native/syncsvc.py wraps build + spawn + lifecycle).

#include <arpa/inet.h>
#include <atomic>
#include <climits>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <string_view>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

double now_secs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + double(ts.tv_nsec) * 1e-9;
}

// ---------------------------------------------------------------- JSON bits
// Minimal zero-copy field extraction over one request line: values come
// back as string_views into the line (raw JSON text); strings unescape
// through a caller-provided scratch only when they actually contain
// escapes. The hot ops never allocate.

using sv = std::string_view;

// Skip a JSON value starting at i; returns one-past-end, or npos on error.
size_t skip_value(sv s, size_t i) {
  while (i < s.size() && isspace((unsigned char)s[i])) i++;
  if (i >= s.size()) return sv::npos;
  char c = s[i];
  if (c == '"') {
    for (i++; i < s.size(); i++) {
      if (s[i] == '\\') { i++; continue; }
      if (s[i] == '"') return i + 1;
    }
    return sv::npos;
  }
  if (c == '{' || c == '[') {
    char open = c, close = (c == '{') ? '}' : ']';
    int depth = 0;
    bool in_str = false;
    for (; i < s.size(); i++) {
      char d = s[i];
      if (in_str) {
        if (d == '\\') { i++; continue; }
        if (d == '"') in_str = false;
      } else if (d == '"') {
        in_str = true;
      } else if (d == open) {
        depth++;
      } else if (d == close) {
        depth--;
        if (depth == 0) return i + 1;
      }
    }
    return sv::npos;
  }
  // number / true / false / null
  size_t j = i;
  while (j < s.size() && (isalnum((unsigned char)s[j]) || s[j] == '-' ||
                          s[j] == '+' || s[j] == '.'))
    j++;
  return j == i ? sv::npos : j;
}

// Raw JSON text of top-level field `key`, or empty if absent.
sv find_field(sv line, sv key) {
  size_t i = 0;
  bool in_str = false;
  int depth = 0;
  for (; i < line.size(); i++) {
    char c = line[i];
    if (in_str) {
      if (c == '\\') { i++; continue; }
      if (c == '"') in_str = false;
      continue;
    }
    if (c == '{' || c == '[') { depth++; continue; }
    if (c == '}' || c == ']') { depth--; continue; }
    if (c == '"') {
      if (depth == 1 && i + key.size() + 2 <= line.size() &&
          line[i + key.size() + 1] == '"' &&
          line.compare(i + 1, key.size(), key) == 0) {
        size_t j = i + key.size() + 2;
        while (j < line.size() && isspace((unsigned char)line[j])) j++;
        if (j < line.size() && line[j] == ':') {
          size_t start = j + 1;
          while (start < line.size() && isspace((unsigned char)line[start]))
            start++;
          size_t end = skip_value(line, start);
          if (end == sv::npos) return sv{};
          return line.substr(start, end - start);
        }
      }
      in_str = true;
    }
  }
  return sv{};
}

void utf8_append(std::string& out, unsigned cp) {
  if (cp < 0x80) {
    out += char(cp);
  } else if (cp < 0x800) {
    out += char(0xC0 | (cp >> 6));
    out += char(0x80 | (cp & 0x3F));
  } else {
    out += char(0xE0 | (cp >> 12));
    out += char(0x80 | ((cp >> 6) & 0x3F));
    out += char(0x80 | (cp & 0x3F));
  }
}

// Decode a raw JSON string token ("...") to its value. Escape-free
// strings (every state/topic the SDK generates) come back as a view
// into the input; only escaped ones round-trip through `scratch`.
sv json_unescape(sv raw, std::string& scratch) {
  if (raw.size() < 2 || raw.front() != '"' || raw.back() != '"') return sv{};
  sv body = raw.substr(1, raw.size() - 2);
  if (body.find('\\') == sv::npos) return body;  // the no-alloc fast path
  scratch.clear();
  scratch.reserve(body.size());
  for (size_t i = 0; i < body.size(); i++) {
    char c = body[i];
    if (c != '\\') { scratch += c; continue; }
    if (++i >= body.size()) break;
    switch (body[i]) {
      case 'n': scratch += '\n'; break;
      case 't': scratch += '\t'; break;
      case 'r': scratch += '\r'; break;
      case 'b': scratch += '\b'; break;
      case 'f': scratch += '\f'; break;
      case 'u': {
        if (i + 4 < body.size()) {
          unsigned cp = (unsigned)strtoul(
              std::string(body.substr(i + 1, 4)).c_str(), nullptr, 16);
          utf8_append(scratch, cp);
          i += 4;
        }
        break;
      }
      default: scratch += body[i];
    }
  }
  return sv(scratch);
}

std::string json_escape(sv s) {
  std::string out;
  out.reserve(s.size() + 2);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

long field_long(sv line, sv key, long dflt) {
  sv raw = find_field(line, key);
  if (raw.empty() || raw == "null") return dflt;
  char buf[32];
  size_t n = raw.size() < sizeof buf - 1 ? raw.size() : sizeof buf - 1;
  memcpy(buf, raw.data(), n);
  buf[n] = 0;
  return strtol(buf, nullptr, 10);
}

double field_double(sv line, sv key, double dflt) {
  sv raw = find_field(line, key);
  if (raw.empty() || raw == "null") return dflt;
  char buf[40];
  size_t n = raw.size() < sizeof buf - 1 ? raw.size() : sizeof buf - 1;
  memcpy(buf, raw.data(), n);
  buf[n] = 0;
  return strtod(buf, nullptr);
}

// ------------------------------------------------------------------- state

// Outbound reply routed to another shard's conn, generation-tagged so a
// recycled fd never sees a dead peer's frames.
struct Msg {
  int fd;
  uint64_t gen;
  std::string line;  // '\n'-terminated
};

struct Conn {
  int fd = -1;
  uint64_t gen = 0;
  double last_active = 0.0;  // last byte read (idle-sweep clock)
  bool hello = false;        // identity registered
  bool clean = false;        // said bye — no eviction event
  bool dead = false;         // marked for drop at end of this drain
  bool dropped = false;      // drop_conn ran; map entry erased post-flush
  bool dirty = false;        // has unflushed output this drain
  bool want_write = false;   // EPOLLOUT armed
  std::string rbuf;
  // flat outbound buffer: replies append at the tail, the flush sends
  // the [whead, size) suffix in ONE syscall; cleared (capacity kept)
  // once fully drained
  std::string wbuf;
  size_t whead = 0;
  std::string events_topic;
  std::string group;
  long instance = -1;
};

struct Shard {
  int id = 0;
  int ep = -1;
  int evfd = -1;
  std::unordered_map<int, Conn> conns;
  std::mutex inbox_mu;
  std::vector<Msg> inbox;
  // drain-cycle scratch (loop thread only)
  std::vector<Conn*> dirty;
  std::vector<int> dead;
  long accepted = 0;  // accepts this drain, folded into stats in bulk
};

int g_nshards = 1;
std::deque<Shard> g_shards;  // deque: Shard holds a mutex (non-movable)
thread_local Shard* t_shard = nullptr;
thread_local std::vector<std::vector<Msg>>* t_outbound = nullptr;
thread_local std::unordered_set<std::string>* t_touched_states = nullptr;
thread_local std::unordered_set<std::string>* t_touched_topics = nullptr;

// A reply backlog beyond this marks the client dead (it stopped
// reading); shedding it beats stalling or ballooning for everyone else.
size_t g_max_wbuf = 16 << 20;

std::atomic<uint64_t> g_gen{1};
std::atomic<long> g_conn_count{0};

struct Waiter {  // a parked barrier / signal_and_wait (record, no thread)
  int fd;
  uint64_t gen;
  int shard;
  long id;
  long target;
  long seq;        // -1 for plain barrier; echoed for signal_and_wait
  double deadline; // 0 = none
};

// Per-state waiter index with a min-target watermark: a signal on an
// armed state is O(1) until some waiter is actually satisfiable; the
// release pass then fans out every satisfied waiter in one sweep.
struct StateWaiters {
  std::vector<Waiter> v;
  long min_target = LONG_MAX;
};

struct Sub {
  int fd;
  uint64_t gen;
  int shard;
  long id;
  size_t cursor;
};

struct Topic {
  std::vector<std::string> entries;  // raw JSON payloads, verbatim
  std::vector<Sub> subs;
};

// ---- everything below is guarded by g_mu (taken once per drain) ----
std::mutex g_mu;
std::unordered_map<std::string, long> counters;
std::unordered_map<std::string, StateWaiters> waiters_by_state;
size_t g_waiter_count = 0;
double g_next_deadline = 0.0;  // earliest parked deadline; 0 = none
std::unordered_map<std::string, Topic> topics;
// idempotency tokens (key: state/topic + '\x1f' + token → original seq),
// FIFO-bounded: only a reconnecting client's unacked window (seconds of
// traffic) ever needs a token, so capping at kMaxTokens bounds memory
// over week-long runs without risking a realistic double-apply.
constexpr size_t kMaxTokens = 65536;
struct TokenMap {
  std::unordered_map<std::string, long> map;
  std::deque<std::string> order;
  long* find(const std::string& key) {
    auto it = map.find(key);
    return it == map.end() ? nullptr : &it->second;
  }
  void put(const std::string& key, long seq) {
    if (map.emplace(key, seq).second) {
      order.push_back(key);
      while (order.size() > kMaxTokens) {
        map.erase(order.front());
        order.pop_front();
      }
    }
  }
};
TokenMap sig_tokens;
TokenMap pub_tokens;
std::string boot_id;       // changes every server start (restart detector)
double idle_timeout = 0.0;  // seconds; 0 = sweep disabled
double evict_grace = 2.0;   // reconnect window before eviction publishes

// reusable lookup keys for view-keyed map access (C++17 unordered maps
// cannot look up by string_view; assigning into a retained-capacity
// string costs a memcpy, not an allocation)
thread_local std::string t_key1, t_key2, t_scratch1, t_scratch2;

std::string& keyed(std::string& slot, sv view) {
  slot.assign(view.data(), view.size());
  return slot;
}

// ------------------------------------------------ sync-stats plane (v2)
// Counter-level mirror of the Python server's stats plane
// (testground_tpu_torch/sync/stats.py; wire parity pinned by
// tests/test_sync_stats.py). Histograms and barrier-episode timing are
// python-server-only richness — this server stays at counters, which
// cost one increment on already-dispatched paths. --stats 0 disables
// the plane (sync_stats answers the v1 occupancy shape), which exists
// for the fan-in bench's instrumented-vs-uninstrumented A/B.
bool stats_on = true;
double stats_start = 0.0;
struct SyncStatsCounters {
  // per-op dispatch counters (counted BEFORE the reply is built, so a
  // sync_stats reply includes itself — the conservation contract)
  long signal_entry = 0, counter = 0, barrier = 0, signal_and_wait = 0,
       publish = 0, subscribe = 0, ping = 0, hello = 0, bye = 0,
       sync_stats = 0;
  // connection churn
  long accepts = 0, closes = 0, evictions = 0;
  size_t conns_hwm = 0;
  // barrier lifecycle (per-waiter)
  long bar_parked = 0, bar_released = 0, bar_timed_out = 0,
       bar_canceled = 0;
  // pubsub
  long published = 0;
  size_t depth_hwm = 0, subs_open = 0, subs_hwm = 0;
  // idempotency dedup
  long dedup_signal = 0, dedup_publish = 0;
};
SyncStatsCounters g_stats;

std::string sync_stats_v2_tail() {
  // the v2 extension blocks appended after the v1 fields; pubsub
  // topic/entry gauges count NON-EMPTY topics so both backends agree
  // (this map grows an empty record on subscribe, the Python dict
  // does not)
  size_t nonempty = 0, entries = 0;
  for (const auto& kv : topics)
    if (!kv.second.entries.empty()) {
      nonempty++;
      entries += kv.second.entries.size();
    }
  const SyncStatsCounters& g = g_stats;
  char buf[1536];
  snprintf(
      buf, sizeof buf,
      ", \"v\": 2, \"uptime_secs\": %.3f"
      ", \"ops\": {\"signal_entry\": %ld, \"counter\": %ld, \"barrier\": "
      "%ld, \"signal_and_wait\": %ld, \"publish\": %ld, \"subscribe\": "
      "%ld, \"ping\": %ld, \"hello\": %ld, \"bye\": %ld, \"sync_stats\": "
      "%ld}"
      ", \"conn\": {\"accepts\": %ld, \"closes\": %ld, \"evictions\": "
      "%ld, \"hwm\": %zu}"
      ", \"barriers\": {\"parked\": %ld, \"released\": %ld, "
      "\"timed_out\": %ld, \"canceled\": %ld}"
      ", \"pubsub\": {\"published\": %ld, \"topics\": %zu, \"entries\": "
      "%zu, \"depth_hwm\": %zu, \"subs_hwm\": %zu}"
      ", \"dedup\": {\"signal_hits\": %ld, \"publish_hits\": %ld}",
      now_secs() - stats_start, g.signal_entry, g.counter, g.barrier,
      g.signal_and_wait, g.publish, g.subscribe, g.ping, g.hello, g.bye,
      g.sync_stats, g.accepts, g.closes, g.evictions, g.conns_hwm,
      g.bar_parked, g.bar_released, g.bar_timed_out, g.bar_canceled,
      g.published, nonempty, entries, g.depth_hwm, g.subs_hwm,
      g.dedup_signal, g.dedup_publish);
  return std::string(buf);
}

// live connection count per hello'd identity, plus evictions waiting out
// their grace window (canceled when the identity reconnects in time)
std::unordered_map<std::string, int> live_ids;
struct PendingEvict {
  std::string key;
  double due;
  std::string topic;
  std::string payload;
};
std::vector<PendingEvict> pending_evictions;

volatile sig_atomic_t stop_flag = 0;  // set by SIGTERM/SIGINT

// --------------------------------------------------------------- outbound

// Append one frame to a local conn's flat write buffer; sheds the peer
// if its backlog trips the bound (it stopped reading).
void out_append(Conn& c, const char* data, size_t n) {
  if (c.dead) return;
  c.wbuf.append(data, n);
  if (c.wbuf.size() - c.whead > g_max_wbuf) {
    if (stats_on) g_stats.evictions++;
    c.dead = true;
    t_shard->dead.push_back(c.fd);
    return;
  }
  if (!c.dirty) {
    c.dirty = true;
    t_shard->dirty.push_back(&c);
  }
}

void out_append(Conn& c, sv s) { out_append(c, s.data(), s.size()); }

// Route a reply to whichever shard owns the conn (generation-checked).
void route_line(int fd, uint64_t gen, int shard, std::string&& line) {
  if (shard == t_shard->id) {
    auto it = t_shard->conns.find(fd);
    if (it != t_shard->conns.end() && it->second.gen == gen)
      out_append(it->second, line.data(), line.size());
  } else {
    (*t_outbound)[shard].push_back(Msg{fd, gen, std::move(line)});
  }
}

void reply_err(Conn& c, long id, sv msg) {
  char buf[64];
  int n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"error\": \"", id);
  out_append(c, buf, (size_t)n);
  std::string esc = json_escape(msg);
  out_append(c, esc.data(), esc.size());
  out_append(c, "\"}\n", 3);
}

// Try to drain a connection's write buffer; non-blocking, never stalls
// the loop. Marks the conn dead on a hard error.
void flush_conn(Conn& c) {
  while (c.whead < c.wbuf.size()) {
    ssize_t w = send(c.fd, c.wbuf.data() + c.whead,
                     c.wbuf.size() - c.whead, MSG_NOSIGNAL | MSG_DONTWAIT);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) break;
      c.dead = true;
      t_shard->dead.push_back(c.fd);
      return;
    }
    c.whead += (size_t)w;
  }
  if (c.whead >= c.wbuf.size()) {
    c.whead = 0;
    if (c.wbuf.capacity() > (256 << 10)) {
      std::string().swap(c.wbuf);  // a fanout spike must not pin memory
    } else {
      c.wbuf.clear();
    }
  }
  bool need_write = c.whead < c.wbuf.size();
  if (need_write != c.want_write) {
    c.want_write = need_write;
    struct epoll_event ev{};
    ev.events = EPOLLIN | (need_write ? EPOLLOUT : 0);
    ev.data.ptr = &c;
    epoll_ctl(t_shard->ep, EPOLL_CTL_MOD, c.fd, &ev);
  }
}

// ----------------------------------------------------- coalesced release

// Release every satisfiable waiter of one state in a single sweep
// (BATCHED barrier release: one state transition fans out W replies
// through the per-conn/per-shard outbound buffers instead of W
// independent write paths). Called from the per-drain release pass.
void release_state(const std::string& state) {
  auto it = waiters_by_state.find(state);
  if (it == waiters_by_state.end()) return;
  StateWaiters& sw = it->second;
  long count = counters[state];
  if (count < sw.min_target) return;  // the O(1) watermark skip
  long new_min = LONG_MAX;
  size_t kept = 0;
  for (size_t i = 0; i < sw.v.size(); i++) {
    Waiter& w = sw.v[i];
    if (count >= w.target) {
      char buf[128];
      int n;
      if (w.seq >= 0)
        n = snprintf(buf, sizeof buf,
                     "{\"id\": %ld, \"seq\": %ld, \"ok\": true}\n", w.id,
                     w.seq);
      else
        n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"ok\": true}\n",
                     w.id);
      if (stats_on) g_stats.bar_released++;
      g_waiter_count--;
      route_line(w.fd, w.gen, w.shard, std::string(buf, (size_t)n));
    } else {
      if (w.target < new_min) new_min = w.target;
      sw.v[kept++] = w;
    }
  }
  sw.v.resize(kept);
  sw.min_target = new_min;
  if (sw.v.empty()) waiters_by_state.erase(it);
}

// Stream every undelivered entry of one topic to each subscriber, one
// pass, frames batched into the per-conn outbound buffers.
void fanout_topic(const std::string& topic_name) {
  auto it = topics.find(topic_name);
  if (it == topics.end()) return;
  Topic& t = it->second;
  if (t.subs.empty() || t.entries.empty()) return;
  for (Sub& sub : t.subs) {
    while (sub.cursor < t.entries.size()) {
      char head[64];
      int hn = snprintf(head, sizeof head, "{\"id\": %ld, \"entry\": ",
                        sub.id);
      sub.cursor++;
      char tail[40];
      int tn = snprintf(tail, sizeof tail, ", \"seq\": %zu}\n", sub.cursor);
      const std::string& entry = t.entries[sub.cursor - 1];
      if (sub.shard == t_shard->id) {
        auto cit = t_shard->conns.find(sub.fd);
        if (cit != t_shard->conns.end() && cit->second.gen == sub.gen) {
          Conn& c = cit->second;
          out_append(c, head, (size_t)hn);
          out_append(c, entry.data(), entry.size());
          out_append(c, tail, (size_t)tn);
        }
      } else {
        std::string line;
        line.reserve(hn + entry.size() + tn);
        line.append(head, (size_t)hn);
        line += entry;
        line.append(tail, (size_t)tn);
        (*t_outbound)[sub.shard].push_back(
            Msg{sub.fd, sub.gen, std::move(line)});
      }
    }
  }
}

void expire_waiters(double now) {
  if (g_next_deadline <= 0 || now < g_next_deadline) return;
  double next = 0.0;
  for (auto it = waiters_by_state.begin(); it != waiters_by_state.end();) {
    StateWaiters& sw = it->second;
    long new_min = LONG_MAX;
    size_t kept = 0;
    for (size_t i = 0; i < sw.v.size(); i++) {
      Waiter& w = sw.v[i];
      if (w.deadline > 0 && now >= w.deadline) {
        if (stats_on) g_stats.bar_timed_out++;
        g_waiter_count--;
        char buf[96];
        int n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"error\": \"",
                         w.id);
        route_line(w.fd, w.gen, w.shard,
                   std::string(buf, (size_t)n) +
                       json_escape("barrier timed out: " + it->first) +
                       "\"}\n");
      } else {
        if (w.deadline > 0 && (next == 0.0 || w.deadline < next))
          next = w.deadline;
        if (w.target < new_min) new_min = w.target;
        sw.v[kept++] = w;
      }
    }
    sw.v.resize(kept);
    sw.min_target = new_min;
    if (sw.v.empty())
      it = waiters_by_state.erase(it);
    else
      ++it;
  }
  g_next_deadline = next;
}

// Signal with optional idempotency token: a re-sent request (reconnect
// replay) answers with the original seq instead of double-counting.
long signal_with_token(sv state, sv token) {
  if (!token.empty()) {
    std::string& key = keyed(t_key2, state);
    key += '\x1f';
    key.append(token.data(), token.size());
    if (long* prev = sig_tokens.find(key)) {
      if (stats_on) g_stats.dedup_signal++;
      return *prev;
    }
    long seq = ++counters[keyed(t_key1, state)];
    sig_tokens.put(key, seq);
    return seq;
  }
  return ++counters[keyed(t_key1, state)];
}

// Append a server-generated entry (eviction events) to a topic.
void publish_entry(const std::string& topic, const std::string& payload) {
  Topic& t = topics[topic];
  t.entries.push_back(payload);
  if (stats_on) {
    g_stats.published++;
    if (t.entries.size() > g_stats.depth_hwm)
      g_stats.depth_hwm = t.entries.size();
  }
  t_touched_topics->insert(topic);
}

std::string ident_key(const Conn& c) {
  return c.events_topic + '\x1f' + c.group + '\x1f' +
         std::to_string(c.instance);
}

// ---------------------------------------------------------------- dispatch

void count_op_slow(sv op) {
  SyncStatsCounters& g = g_stats;
  if (op == "counter") g.counter++;
  else if (op == "barrier") g.barrier++;
  else if (op == "signal_and_wait") g.signal_and_wait++;
  else if (op == "publish") g.publish++;
  else if (op == "subscribe") g.subscribe++;
  else if (op == "ping") g.ping++;
  else if (op == "hello") g.hello++;
  else if (op == "bye") g.bye++;
  else if (op == "sync_stats") g.sync_stats++;
}

void handle_line(Conn& conn, sv line) {
  long id = field_long(line, "id", -1);
  sv op = json_unescape(find_field(line, "op"), t_scratch1);
  char buf[160];
  if (op == "signal_entry") {  // THE hot op: fully allocation-free
    if (stats_on) g_stats.signal_entry++;
    sv state = json_unescape(find_field(line, "state"), t_scratch1);
    sv token = json_unescape(find_field(line, "token"), t_scratch2);
    long seq = signal_with_token(state, token);
    int n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"seq\": %ld}\n", id,
                     seq);
    out_append(conn, buf, (size_t)n);
    // a signal can only release someone if anyone is parked at all —
    // the flood fast path skips the touched-set entirely
    if (g_waiter_count)
      t_touched_states->emplace(state.data(), state.size());
    return;
  }
  if (op.empty()) {
    reply_err(conn, -1, "malformed request");
    return;
  }
  if (stats_on) count_op_slow(op);
  if (op == "ping") {
    int n = snprintf(buf, sizeof buf,
                     "{\"id\": %ld, \"pong\": true, \"boot\": \"%s\"}\n",
                     id, boot_id.c_str());
    out_append(conn, buf, (size_t)n);
  } else if (op == "hello") {
    if (conn.hello) {  // re-hello on the same conn: retag the identity
      auto lit = live_ids.find(ident_key(conn));
      if (lit != live_ids.end() && --lit->second <= 0) live_ids.erase(lit);
    }
    conn.hello = true;
    sv et = json_unescape(find_field(line, "events_topic"), t_scratch1);
    conn.events_topic.assign(et.data(), et.size());
    sv grp = json_unescape(find_field(line, "group"), t_scratch1);
    conn.group.assign(grp.data(), grp.size());
    conn.instance = field_long(line, "instance", -1);
    live_ids[ident_key(conn)]++;
    int n = snprintf(buf, sizeof buf,
                     "{\"id\": %ld, \"ok\": true, \"boot\": \"%s\"}\n", id,
                     boot_id.c_str());
    out_append(conn, buf, (size_t)n);
  } else if (op == "bye") {
    conn.clean = true;
    int n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"ok\": true}\n", id);
    out_append(conn, buf, (size_t)n);
  } else if (op == "sync_stats") {
    size_t nsubs = 0;
    for (const auto& kv : topics) nsubs += kv.second.subs.size();
    int n = snprintf(buf, sizeof buf,
                     "{\"id\": %ld, \"conns\": %ld, \"waiters\": %zu, "
                     "\"subs\": %zu, \"boot\": \"%s\"",
                     id, g_conn_count.load(), g_waiter_count, nsubs,
                     boot_id.c_str());
    std::string r(buf, (size_t)n);
    if (stats_on) r += sync_stats_v2_tail();
    r += "}\n";
    out_append(conn, r.data(), r.size());
  } else if (op == "counter") {
    sv state = json_unescape(find_field(line, "state"), t_scratch1);
    int n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"count\": %ld}\n",
                     id, counters[keyed(t_key1, state)]);
    out_append(conn, buf, (size_t)n);
  } else if (op == "barrier" || op == "signal_and_wait") {
    // `op` may itself be a view into t_scratch1 (escape-containing op
    // name); latch the distinction BEFORE state unescaping clobbers it
    bool is_saw = (op == "signal_and_wait");
    sv state = json_unescape(find_field(line, "state"), t_scratch1);
    long target = field_long(line, "target", 0);
    // absent/null timeout = wait forever; an EXPLICIT 0 is an immediate
    // non-blocking check (the Python spec server's semantics): unmet
    // after this drain's release pass → timed out
    double timeout = field_double(line, "timeout", -1.0);
    long seq = -1;
    if (is_saw)
      seq = signal_with_token(
          state, json_unescape(find_field(line, "token"), t_scratch2));
    double deadline = timeout >= 0 ? now_secs() + timeout : 0.0;
    if (stats_on) g_stats.bar_parked++;
    StateWaiters& sw = waiters_by_state[keyed(t_key1, state)];
    if (target < sw.min_target) sw.min_target = target;
    sw.v.push_back(
        Waiter{conn.fd, conn.gen, t_shard->id, id, target, seq, deadline});
    g_waiter_count++;
    if (timeout >= 0 &&
        (g_next_deadline == 0.0 || deadline < g_next_deadline))
      g_next_deadline = deadline;
    t_touched_states->emplace(state.data(), state.size());
  } else if (op == "publish") {
    sv topic = json_unescape(find_field(line, "topic"), t_scratch1);
    sv payload = find_field(line, "payload");
    if (payload.empty()) payload = "null";
    sv token = json_unescape(find_field(line, "token"), t_scratch2);
    long seq;
    long* prev = nullptr;
    if (!token.empty()) {
      std::string& tkey = keyed(t_key2, topic);
      tkey += '\x1f';
      tkey.append(token.data(), token.size());
      prev = pub_tokens.find(tkey);
    }
    if (prev) {  // replayed publish
      if (stats_on) g_stats.dedup_publish++;
      seq = *prev;
    } else {
      Topic& t = topics[keyed(t_key1, topic)];
      t.entries.emplace_back(payload.data(), payload.size());
      seq = (long)t.entries.size();
      if (!token.empty()) pub_tokens.put(t_key2, seq);
      if (stats_on) {
        g_stats.published++;
        if (t.entries.size() > g_stats.depth_hwm)
          g_stats.depth_hwm = t.entries.size();
      }
    }
    int n = snprintf(buf, sizeof buf, "{\"id\": %ld, \"seq\": %ld}\n", id,
                     seq);
    out_append(conn, buf, (size_t)n);
    t_touched_topics->emplace(topic.data(), topic.size());
  } else if (op == "subscribe") {
    sv topic = json_unescape(find_field(line, "topic"), t_scratch1);
    topics[keyed(t_key1, topic)].subs.push_back(
        Sub{conn.fd, conn.gen, t_shard->id, id, 0});
    if (stats_on && ++g_stats.subs_open > g_stats.subs_hwm)
      g_stats.subs_hwm = g_stats.subs_open;
    t_touched_topics->emplace(topic.data(), topic.size());
  } else {
    reply_err(conn, id, "unknown op '" + std::string(op) + "'");
  }
}

// --------------------------------------------------------------- teardown

void drop_conn(Conn& c) {
  // salvage identity before erasing: an abnormal disconnect of a
  // hello'd instance SCHEDULES an eviction event AFTER its occupancy
  // (parked waiters, subscriptions) is released — published only if no
  // connection with the same identity is back within evict_grace (a
  // client dropping its socket to reconnect is not dead)
  if (c.hello) {
    std::string key = ident_key(c);
    auto lit = live_ids.find(key);
    int remaining = 0;
    if (lit != live_ids.end() && --lit->second <= 0) {
      live_ids.erase(lit);
    } else if (lit != live_ids.end()) {
      remaining = lit->second;
    }
    if (!c.clean && !c.events_topic.empty() && !stop_flag &&
        remaining == 0) {
      pending_evictions.push_back(PendingEvict{
          key, now_secs() + evict_grace, c.events_topic,
          std::string("{\"type\": \"evicted\", \"group\": \"") +
              json_escape(c.group) + "\", \"instance\": " +
              std::to_string(c.instance) +
              ", \"error\": \"connection lost (killed, partitioned, or "
              "idle-evicted)\"}"});
    }
  }
  if (stats_on) g_stats.closes++;
  g_conn_count--;
  // purge parked waiters and subscriptions (by fd + generation)
  for (auto it = waiters_by_state.begin(); it != waiters_by_state.end();) {
    StateWaiters& sw = it->second;
    long new_min = LONG_MAX;
    size_t kept = 0;
    for (size_t i = 0; i < sw.v.size(); i++) {
      Waiter& w = sw.v[i];
      if (w.fd == c.fd && w.gen == c.gen) {
        if (stats_on) g_stats.bar_canceled++;  // conn lost mid-barrier
        g_waiter_count--;
      } else {
        if (w.target < new_min) new_min = w.target;
        sw.v[kept++] = w;
      }
    }
    sw.v.resize(kept);
    sw.min_target = new_min;
    if (sw.v.empty())
      it = waiters_by_state.erase(it);
    else
      ++it;
  }
  for (auto& kv : topics) {
    auto& subs = kv.second.subs;
    for (size_t i = 0; i < subs.size();) {
      if (subs[i].fd == c.fd && subs[i].gen == c.gen) {
        if (stats_on && g_stats.subs_open > 0) g_stats.subs_open--;
        subs[i] = subs.back();
        subs.pop_back();
      } else {
        i++;
      }
    }
  }
  close(c.fd);  // also removes it from the shard's epoll set
}

// Publish due evictions whose identity never came back; an identity
// that reconnected inside its grace window is silently canceled.
void flush_evictions() {
  if (pending_evictions.empty()) return;
  double now = now_secs();
  for (size_t i = 0; i < pending_evictions.size();) {
    PendingEvict& pe = pending_evictions[i];
    if (live_ids.count(pe.key)) {  // came back — cancel
      pe = pending_evictions.back();
      pending_evictions.pop_back();
    } else if (now >= pe.due) {
      publish_entry(pe.topic, pe.payload);
      pending_evictions[i] = pending_evictions.back();
      pending_evictions.pop_back();
    } else {
      i++;
    }
  }
}

// Mark this shard's connections silent past the idle window dead: a
// heartbeating client is never idle, so only dead/partitioned peers
// (whose kernel may keep the socket ESTABLISHED forever) trip this.
void sweep_idle(double now) {
  if (idle_timeout <= 0) return;
  for (auto& kv : t_shard->conns)
    if (!kv.second.dead && now - kv.second.last_active > idle_timeout) {
      if (stats_on) g_stats.evictions++;
      kv.second.dead = true;
      t_shard->dead.push_back(kv.first);
    }
}

void on_term(int) { stop_flag = 1; }

// ------------------------------------------------------------- shard loop

int g_listen_fd = -1;
// epoll data.ptr tags for the two non-conn fds in each shard's set
void* const kTagListener = nullptr;
char g_evfd_tag;  // address used as the eventfd tag

void shard_loop(Shard* shard) {
  t_shard = shard;
  std::vector<std::vector<Msg>> outbound(g_nshards);
  t_outbound = &outbound;
  std::unordered_set<std::string> touched_states, touched_topics;
  t_touched_states = &touched_states;
  t_touched_topics = &touched_topics;

  {  // listener shared across shards: the kernel picks ONE shard per
     // pending connection (accept fan-out)
    struct epoll_event ev{};
    ev.events = EPOLLIN | EPOLLEXCLUSIVE;
    ev.data.ptr = kTagListener;
    epoll_ctl(shard->ep, EPOLL_CTL_ADD, g_listen_fd, &ev);
  }
  {
    struct epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = &g_evfd_tag;
    epoll_ctl(shard->ep, EPOLL_CTL_ADD, shard->evfd, &ev);
  }

  constexpr int kMaxEvents = 1024;
  std::vector<struct epoll_event> evs(kMaxEvents);
  char rbuf[65536];
  std::vector<Conn*> batch;  // conns with complete lines this drain

  while (!stop_flag) {
    // ---- timeout: nearest barrier deadline / idle sweep / evictions
    int tmo = -1;
    {
      std::lock_guard<std::mutex> lk(g_mu);
      if (g_next_deadline > 0) {
        int ms = (int)((g_next_deadline - now_secs()) * 1000) + 1;
        if (ms < 0) ms = 0;
        tmo = ms;
      }
      if (!pending_evictions.empty() && (tmo < 0 || tmo > 100)) tmo = 100;
    }
    if (idle_timeout > 0) {
      int sweep_ms = (int)(idle_timeout * 250);  // idle_timeout / 4
      if (sweep_ms < 100) sweep_ms = 100;
      if (tmo < 0 || sweep_ms < tmo) tmo = sweep_ms;
    }
    if (!shard->dead.empty()) tmo = 0;
    int rc = epoll_wait(shard->ep, evs.data(), kMaxEvents, tmo);
    if (rc < 0 && errno != EINTR) break;
    if (stop_flag) break;
    double now = now_secs();

    // ---- phase A (no lock): accept + read; batch conns with lines
    batch.clear();
    for (int i = 0; i < rc; i++) {
      void* tag = evs[i].data.ptr;
      uint32_t e = evs[i].events;
      if (tag == kTagListener) {
        while (true) {
          int cfd = accept4(g_listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          auto [it, fresh] = shard->conns.try_emplace(cfd);
          Conn& c = it->second;
          c = Conn{};
          c.fd = cfd;
          c.gen = g_gen.fetch_add(1);
          c.last_active = now;
          g_conn_count++;
          shard->accepted++;
          struct epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.ptr = &c;
          epoll_ctl(shard->ep, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      if (tag == &g_evfd_tag) {
        uint64_t v;
        while (read(shard->evfd, &v, sizeof v) > 0) {
        }
        continue;
      }
      Conn& c = *static_cast<Conn*>(tag);
      if (c.dead) continue;
      if (e & EPOLLOUT) flush_conn(c);
      if (c.dead || !(e & (EPOLLIN | EPOLLHUP | EPOLLERR))) continue;
      ssize_t n = recv(c.fd, rbuf, sizeof rbuf, 0);
      if (n == 0 || (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                     errno != EINTR)) {
        // EOF/reset: any already-received complete lines (e.g. a "bye"
        // right before close) still dispatch below, THEN the drop runs
        c.dead = true;
        shard->dead.push_back(c.fd);
        if (!c.rbuf.empty() && c.rbuf.find('\n') != std::string::npos)
          batch.push_back(&c);
      } else if (n > 0) {
        c.last_active = now;
        c.rbuf.append(rbuf, (size_t)n);
        if (memchr(c.rbuf.data(), '\n', c.rbuf.size()))
          batch.push_back(&c);
      }
    }

    // inbox: replies routed here by other shards
    std::vector<Msg> incoming;
    if (g_nshards > 1) {
      std::lock_guard<std::mutex> lk(shard->inbox_mu);
      incoming.swap(shard->inbox);
    }

    // ---- phase B (one lock): apply the whole batch + coalesced passes
    {
      std::lock_guard<std::mutex> lk(g_mu);
      if (shard->accepted) {
        if (stats_on) {
          g_stats.accepts += shard->accepted;
          long live = g_conn_count.load();
          if ((size_t)live > g_stats.conns_hwm)
            g_stats.conns_hwm = (size_t)live;
        }
        shard->accepted = 0;
      }
      for (Msg& m : incoming) {
        auto it = shard->conns.find(m.fd);
        if (it != shard->conns.end() && it->second.gen == m.gen)
          out_append(it->second, m.line.data(), m.line.size());
      }
      for (Conn* cp : batch) {
        Conn& c = *cp;
        sv rest(c.rbuf);
        size_t consumed = 0;
        while (true) {
          size_t nl = rest.find('\n');
          if (nl == sv::npos) break;
          sv line = rest.substr(0, nl);
          rest.remove_prefix(nl + 1);
          consumed += nl + 1;
          // a shed conn (write-bound tripped) stops dispatching; an
          // EOF'd conn still drains its final lines (e.g. bye)
          if (!line.empty() &&
              !(c.dead && c.wbuf.size() - c.whead > g_max_wbuf))
            handle_line(c, line);
        }
        c.rbuf.erase(0, consumed);
      }
      sweep_idle(now);
      // mark-drop only: the map entry (and thus every Conn* in this
      // drain's dirty list and epoll events) stays valid until the
      // post-flush erase below
      for (int fd : shard->dead) {
        auto it = shard->conns.find(fd);
        if (it == shard->conns.end() || it->second.dropped) continue;
        it->second.dropped = true;
        drop_conn(it->second);
      }
      flush_evictions();
      // release BEFORE expire: a zero-timeout barrier that is already
      // satisfiable must release this drain, not time out (the Python
      // spec's wait_for(timeout=0) checks the predicate first)
      for (const std::string& s : touched_states) release_state(s);
      touched_states.clear();
      for (const std::string& t : touched_topics) fanout_topic(t);
      touched_topics.clear();
      expire_waiters(now);
    }

    // ---- phase C (no lock): deliver cross-shard replies, flush dirty
    for (int s = 0; s < g_nshards; s++) {
      if (outbound[s].empty()) continue;
      {
        std::lock_guard<std::mutex> lk(g_shards[s].inbox_mu);
        for (Msg& m : outbound[s])
          g_shards[s].inbox.push_back(std::move(m));
      }
      uint64_t one = 1;
      ssize_t wr = write(g_shards[s].evfd, &one, sizeof one);
      (void)wr;
      outbound[s].clear();
    }
    for (Conn* cp : shard->dirty) {
      cp->dirty = false;
      if (!cp->dead) flush_conn(*cp);
    }
    shard->dirty.clear();
    // erase dropped conns now that no Conn* from this drain remains
    // live; conns that died DURING the flush above (not yet dropped)
    // stay queued for the next drain's mark-drop
    size_t keep = 0;
    for (int fd : shard->dead) {
      auto it = shard->conns.find(fd);
      if (it == shard->conns.end()) continue;
      if (it->second.dropped)
        shard->conns.erase(it);
      else
        shard->dead[keep++] = fd;
    }
    shard->dead.resize(keep);
  }
  // shutdown: drop this shard's conns (no eviction events: stop_flag)
  {
    std::lock_guard<std::mutex> lk(g_mu);
    for (auto& kv : shard->conns) drop_conn(kv.second);
    shard->conns.clear();
  }
}

}  // namespace

int main(int argc, char** argv) {
  int port = 0;
  int shards = 0;  // 0 = auto
  const char* host = "127.0.0.1";
  for (int i = 1; i + 1 < argc; i += 2) {
    if (strcmp(argv[i], "--port") == 0) port = atoi(argv[i + 1]);
    if (strcmp(argv[i], "--host") == 0) host = argv[i + 1];
    if (strcmp(argv[i], "--idle-timeout") == 0)
      idle_timeout = atof(argv[i + 1]);
    if (strcmp(argv[i], "--evict-grace") == 0)
      evict_grace = atof(argv[i + 1]);
    // --stats 0 answers sync_stats with the v1 occupancy shape and
    // skips the counters (the fan-in bench's A/B knob)
    if (strcmp(argv[i], "--stats") == 0) stats_on = atoi(argv[i + 1]) != 0;
    if (strcmp(argv[i], "--shards") == 0) shards = atoi(argv[i + 1]);
    if (strcmp(argv[i], "--max-wbuf") == 0)
      g_max_wbuf = (size_t)atol(argv[i + 1]);
  }
  stats_start = now_secs();
  if (shards <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    shards = (int)(hw < 1 ? 1 : (hw > 4 ? 4 : hw));
  }
  g_nshards = shards;

  {  // boot id: distinguishes restarts for reconnecting clients
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    char buf[48];
    snprintf(buf, sizeof buf, "%lx-%lx-%x", (unsigned long)ts.tv_sec,
             (unsigned long)ts.tv_nsec, (unsigned)getpid());
    boot_id = buf;
  }

  signal(SIGTERM, on_term);
  signal(SIGINT, on_term);
  signal(SIGPIPE, SIG_IGN);

  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (strcmp(host, "localhost") == 0) host = "127.0.0.1";
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    fprintf(stderr, "tg-syncsvc: bad --host %s (want an IPv4 address)\n",
            host);
    return 1;
  }
  addr.sin_port = htons((uint16_t)port);
  if (bind(lfd, (sockaddr*)&addr, sizeof addr) != 0 ||
      listen(lfd, 1024) != 0) {
    perror("tg-syncsvc: bind/listen");
    return 1;
  }
  socklen_t alen = sizeof addr;
  getsockname(lfd, (sockaddr*)&addr, &alen);
  g_listen_fd = lfd;

  g_shards.resize(shards);
  for (int i = 0; i < shards; i++) {
    g_shards[i].id = i;
    g_shards[i].ep = epoll_create1(0);
    g_shards[i].evfd = eventfd(0, EFD_NONBLOCK);
    if (g_shards[i].ep < 0 || g_shards[i].evfd < 0) {
      perror("tg-syncsvc: epoll/eventfd");
      return 1;
    }
  }

  printf("LISTENING %d\n", ntohs(addr.sin_port));
  fflush(stdout);

  std::vector<std::thread> threads;
  for (int i = 1; i < shards; i++)
    threads.emplace_back(shard_loop, &g_shards[i]);
  shard_loop(&g_shards[0]);  // shard 0 runs on the main thread
  stop_flag = 1;
  // wake the other shards so their epoll_wait returns promptly
  for (int i = 1; i < shards; i++) {
    uint64_t one64 = 1;
    ssize_t wr = write(g_shards[i].evfd, &one64, sizeof one64);
    (void)wr;
  }
  for (auto& t : threads) t.join();
  close(lfd);
  return 0;
}
