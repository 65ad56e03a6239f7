// Native framed-TCP transport for the distributed runtime.
//
// The reference's transport is labrpc: an in-process channel fabric
// (reference: labrpc/labrpc.go:128-165) — adequate because "serving"
// there means tests.  This is the real-deployment counterpart: real
// sockets speaking length-prefixed binary frames, exposed through a
// plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Architecture — latency first.  A serial RPC's critical path must not
// cross threads inside the transport, so:
//
//   * mrt_send WRITES INLINE on the caller's thread (writev of
//     header+payload) whenever the connection is idle.  Only a partial
//     write (socket buffer full) or a still-connecting socket queues
//     the frame for the background writer.
//   * mrt_poll RUNS THE READ REACTOR INLINE on the calling thread:
//     epoll_wait → read → frame parse → return, no handoff queue, no
//     condvar.  The poller thread IS the read event loop.
//   * a background writer thread exists ONLY for the slow path: it
//     owns a second epoll set holding sockets with queued writes or
//     in-progress connects, flushing on EPOLLOUT.  Idle connections
//     never touch it, so the echo round trip costs exactly two kernel
//     socket wakeups and zero futex handoffs.
//
// Model:
//   * connections are integer ids; the listener auto-accepts and
//     surfaces EV_ACCEPT from mrt_poll
//   * completed inbound frames surface as EV_FRAME events
//   * EV_CLOSED reports peer disconnect/error; ids are never reused
//   * mrt_wake interrupts a blocked mrt_poll (it returns -1 like a
//     timeout) — the scheduler-integration hook, letting one thread be
//     both the IO dispatcher and the timer loop
//
// Thread contract: send/connect/close/wake from any thread; poll from
// exactly one thread, and the owner stops polling before mrt_destroy.
// Progress on queued writes needs no polling (the writer thread covers
// it); inbound frames and connect completions surface only via poll.
//
// Python owns message semantics (codec, request/reply matching); this
// layer owns bytes, liveness, and wakeups.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sched.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int EV_FRAME = 0;
constexpr int EV_ACCEPT = 1;
constexpr int EV_CLOSED = 2;

constexpr uint64_t TAG_WAKE = static_cast<uint64_t>(-1);
constexpr uint64_t TAG_LISTEN = static_cast<uint64_t>(-2);

struct Event {
  int64_t conn;
  int type;
  std::vector<uint8_t> data;
};

struct Conn {
  int fd = -1;
  std::vector<uint8_t> rbuf;            // accumulated inbound bytes
  std::deque<std::vector<uint8_t>> wq;  // pending outbound frames
  size_t woff = 0;                      // offset into wq.front()
  bool closed = false;
  bool err = false;         // closed by error → EV_CLOSED owed to the poller
  bool connecting = false;  // non-blocking connect still in progress
  bool in_wep = false;      // registered in the writer's epoll set
};

class Transport {
 public:
  Transport() {
    repfd_ = epoll_create1(EPOLL_CLOEXEC);
    wepfd_ = epoll_create1(EPOLL_CLOEXEC);
    wake_fd_ = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
    wwake_fd_ = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = TAG_WAKE;
    epoll_ctl(repfd_, EPOLL_CTL_ADD, wake_fd_, &ev);
    epoll_event wev{};
    wev.events = EPOLLIN;
    wev.data.u64 = TAG_WAKE;
    epoll_ctl(wepfd_, EPOLL_CTL_ADD, wwake_fd_, &wev);
    writer_ = std::thread([this] { WriterLoop(); });
  }

  ~Transport() {
    running_ = false;
    WakeWriter();
    writer_.join();
    {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& [id, c] : conns_)
        if (c.fd >= 0) close(c.fd);
      conns_.clear();
    }
    if (listen_fd_ >= 0) close(listen_fd_);
    close(wake_fd_);
    close(wwake_fd_);
    close(repfd_);
    close(wepfd_);
  }

  // Returns bound port (listen on port 0 for ephemeral), or -1.
  int Listen(const char* host, int port) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      close(fd);
      return -1;
    }
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        listen(fd, 128) < 0) {
      close(fd);
      return -1;
    }
    socklen_t len = sizeof(addr);
    getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
    SetNonblock(fd);
    listen_fd_ = fd;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = TAG_LISTEN;
    epoll_ctl(repfd_, EPOLL_CTL_ADD, fd, &ev);
    return ntohs(addr.sin_port);
  }

  // Non-blocking connect: returns a conn id immediately; frames sent
  // before the handshake completes are queued and flushed by the
  // writer when the socket turns writable.  A failed connect surfaces
  // as EV_CLOSED so callers' pending RPCs resolve to "dropped" rather
  // than stalling the caller's event loop on a SYN timeout.
  int64_t Connect(const char* host, int port) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -1;
    SetNonblock(fd);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      close(fd);
      return -1;
    }
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    bool in_progress = rc < 0 && errno == EINPROGRESS;
    if (rc < 0 && !in_progress) {
      close(fd);
      return -1;
    }
    return Register(fd, /*connecting=*/in_progress);
  }

  bool Send(int64_t id, const uint8_t* data, uint32_t len) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = conns_.find(id);
    if (it == conns_.end() || it->second.closed) return false;
    Conn& c = it->second;
    uint32_t be = htonl(len);
    size_t done = 0;
    if (!c.connecting && c.wq.empty()) {
      // Fast path: the connection is idle — write from this thread.
      iovec iov[2];
      iov[0].iov_base = &be;
      iov[0].iov_len = 4;
      iov[1].iov_base = const_cast<uint8_t*>(data);
      iov[1].iov_len = len;
      ssize_t n = writev(c.fd, iov, 2);
      if (n == static_cast<ssize_t>(4 + len)) return true;
      if (n < 0) {
        if (errno != EAGAIN && errno != EWOULDBLOCK) {
          // Dead socket: owe the poller an EV_CLOSED so pending RPCs
          // resolve to "dropped" (the frame is accepted-and-lost, the
          // same outcome the queued path would reach).
          c.closed = true;
          c.err = true;
          WakePoller();
          return true;
        }
        n = 0;
      }
      done = static_cast<size_t>(n);
    }
    std::vector<uint8_t> frame(4 + len);
    memcpy(frame.data(), &be, 4);
    memcpy(frame.data() + 4, data, len);
    c.wq.push_back(std::move(frame));
    if (c.wq.size() == 1) c.woff = done;
    if (!c.connecting) WatchWrites(id, c);
    return true;
  }

  // Vectored raw write: the caller supplies PRE-FRAMED byte parts
  // (length prefixes included) and they hit the socket as one writev —
  // the coalescing half of the zero-copy fast path (tcp.py queues a
  // scheduler-iteration's replies and flushes them here, so N replies
  // cost one syscall instead of N).  Parts need no frame alignment on
  // the slow path: the write queue carries raw byte runs (FlushWrites
  // is offset-based), so a partial writev's remainder becomes one
  // queued blob.
  bool SendV(int64_t id, const uint8_t* const* parts, const uint32_t* lens,
             uint32_t nparts) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = conns_.find(id);
    if (it == conns_.end() || it->second.closed) return false;
    Conn& c = it->second;
    size_t total = 0;
    for (uint32_t i = 0; i < nparts; ++i) total += lens[i];
    size_t done = 0;
    if (!c.connecting && c.wq.empty()) {
      std::vector<iovec> iov(nparts);
      for (uint32_t i = 0; i < nparts; ++i) {
        iov[i].iov_base = const_cast<uint8_t*>(parts[i]);
        iov[i].iov_len = lens[i];
      }
      ssize_t n = writev(c.fd, iov.data(), static_cast<int>(nparts));
      if (n == static_cast<ssize_t>(total)) return true;
      if (n < 0) {
        if (errno != EAGAIN && errno != EWOULDBLOCK) {
          // Dead socket: same accepted-and-lost contract as Send.
          c.closed = true;
          c.err = true;
          WakePoller();
          return true;
        }
        n = 0;
      }
      done = static_cast<size_t>(n);
    }
    std::vector<uint8_t> rest;
    rest.reserve(total - done);
    size_t skip = done;
    for (uint32_t i = 0; i < nparts; ++i) {
      if (skip >= lens[i]) {
        skip -= lens[i];
        continue;
      }
      rest.insert(rest.end(), parts[i] + skip, parts[i] + lens[i]);
      skip = 0;
    }
    c.wq.push_back(std::move(rest));
    if (c.wq.size() == 1) c.woff = 0;
    if (!c.connecting) WatchWrites(id, c);
    return true;
  }

  void CloseConn(int64_t id) {
    {
      std::lock_guard<std::mutex> g(mu_);
      auto it = conns_.find(id);
      if (it == conns_.end() || it->second.closed) return;
      it->second.closed = true;  // user close: torn down silently
    }
    WakePoller();
  }

  void Wake() { WakePoller(); }

  // Busy-poll budget before blocking in epoll_wait.  A serial RPC's
  // reply lands tens of µs after the request goes out; spinning that
  // long instead of sleeping removes the ~5-10 µs futex wake from
  // both sides of the round trip.  Cost when idle: one spin per Poll
  // call (the scheduler polls every idle_max=200 ms) — negligible.
  void SetSpin(int us) { spin_us_ = us; }

  // Blocks up to timeout_ms for an event, running the read reactor on
  // the calling thread.  Returns payload length and fills conn/type;
  // -1 on timeout OR external wake (callers loop).  cap==0 peeks size
  // only (the event stays queued).
  int64_t Poll(int64_t* conn, int* type, uint8_t* buf, uint32_t cap,
               int timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    for (;;) {
      if (!ready_.empty()) {
        Event& e = ready_.front();
        *conn = e.conn;
        *type = e.type;
        int64_t n = static_cast<int64_t>(e.data.size());
        if (n > 0 && cap < e.data.size()) return n;  // caller re-polls bigger
        if (n > 0) memcpy(buf, e.data.data(), e.data.size());
        ready_.pop_front();
        return n;
      }
      auto now = std::chrono::steady_clock::now();
      epoll_event evs[64];
      int n = 0;
      if (spin_us_ > 0) {
        // Spin phase: non-blocking epoll probes until the budget (or
        // the caller's deadline) runs out.  No sched_yield: measured on
        // a single CPU, yielding spinners just starve each other (the
        // multi-thread echo went 25 → 44 µs); spin is only enabled on
        // multicore boxes where the probe loop runs undisturbed.
        auto spin_until =
            std::min(now + std::chrono::microseconds(spin_us_), deadline);
        while ((n = epoll_wait(repfd_, evs, 64, 0)) == 0 &&
               std::chrono::steady_clock::now() < spin_until) {
        }
        if (n == 0 && std::chrono::steady_clock::now() >= deadline)
          return -1;  // deadline consumed by the spin
        now = std::chrono::steady_clock::now();
      }
      if (n == 0) {
        int remaining =
            now >= deadline
                ? 0
                : static_cast<int>(
                      std::chrono::duration_cast<std::chrono::milliseconds>(
                          deadline - now)
                          .count()) +
                      1;
        n = epoll_wait(repfd_, evs, 64, remaining);
      }
      if (n < 0) {
        if (errno == EINTR) continue;
        return -1;
      }
      if (n == 0) return -1;  // timed out
      bool woken = false;
      for (int i = 0; i < n; ++i) {
        uint64_t tag = evs[i].data.u64;
        if (tag == TAG_WAKE) {
          uint64_t junk;
          while (read(wake_fd_, &junk, sizeof(junk)) > 0) {
          }
          woken = true;
          continue;
        }
        if (tag == TAG_LISTEN) {
          for (;;) {
            int fd = accept4(listen_fd_, nullptr, nullptr, SOCK_CLOEXEC);
            if (fd < 0) break;
            int64_t id = Register(fd);
            ready_.push_back(Event{id, EV_ACCEPT, {}});
          }
          continue;
        }
        HandleReadEvent(static_cast<int64_t>(tag), evs[i].events);
      }
      if (woken) {
        SweepClosed();
        if (ready_.empty()) return -1;  // spurious-wake contract
      }
      // Loop: ready_ may have filled; otherwise re-wait on remaining time.
    }
  }

 private:
  void SetNonblock(int fd) {
    fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }

  int64_t Register(int fd, bool connecting = false) {
    SetNonblock(fd);
    int64_t id = next_id_.fetch_add(1);
    {
      std::lock_guard<std::mutex> g(mu_);
      Conn& c = conns_[id];
      c.fd = fd;
      c.connecting = connecting;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.u64 = static_cast<uint64_t>(id);
      epoll_ctl(repfd_, EPOLL_CTL_ADD, fd, &ev);
      // The writer completes the handshake (EPOLLOUT = connected).
      if (connecting) WatchWrites(id, c);
    }
    return id;
  }

  // Register in the writer's epoll set (idempotent).  Caller holds mu_.
  void WatchWrites(int64_t id, Conn& c) {
    if (c.in_wep || c.fd < 0) return;
    epoll_event ev{};
    ev.events = EPOLLOUT;
    ev.data.u64 = static_cast<uint64_t>(id);
    epoll_ctl(wepfd_, EPOLL_CTL_ADD, c.fd, &ev);
    c.in_wep = true;
  }

  void UnwatchWrites(Conn& c) {  // caller holds mu_
    if (!c.in_wep || c.fd < 0) return;
    epoll_ctl(wepfd_, EPOLL_CTL_DEL, c.fd, nullptr);
    c.in_wep = false;
  }

  void WakePoller() {
    uint64_t one = 1;
    [[maybe_unused]] ssize_t r = write(wake_fd_, &one, sizeof(one));
  }

  void WakeWriter() {
    uint64_t one = 1;
    [[maybe_unused]] ssize_t r = write(wwake_fd_, &one, sizeof(one));
  }

  // Poll-thread only: tear down one conn, emitting EV_CLOSED if owed.
  void TearDown(int64_t id, Conn& c, bool notify) {  // caller holds mu_
    UnwatchWrites(c);
    if (c.fd >= 0) {
      epoll_ctl(repfd_, EPOLL_CTL_DEL, c.fd, nullptr);
      close(c.fd);
      c.fd = -1;
    }
    if (notify) ready_.push_back(Event{id, EV_CLOSED, {}});
  }

  // Poll-thread only: collect conns closed by other threads (user
  // CloseConn → silent; Send/writer error → EV_CLOSED).
  void SweepClosed() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto it = conns_.begin(); it != conns_.end();) {
      Conn& c = it->second;
      if (c.closed) {
        TearDown(it->first, c, /*notify=*/c.err);
        it = conns_.erase(it);
      } else {
        ++it;
      }
    }
  }

  // Poll-thread only: one epoll event on a data socket.
  void HandleReadEvent(int64_t id, uint32_t events) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = conns_.find(id);
    if (it == conns_.end()) return;
    Conn& c = it->second;
    if (c.closed) return;  // swept on the next wake
    // Drain readable bytes BEFORE honoring HUP/ERR: a peer that writes
    // a reply and dies delivers EPOLLIN|EPOLLHUP in one event, and the
    // final frame must not be discarded.
    if (!c.connecting && (events & EPOLLIN)) HandleReadable(id, c);
    if (events & (EPOLLHUP | EPOLLERR)) {
      c.closed = true;
      c.err = true;
    }
    if (c.closed) {
      TearDown(id, c, /*notify=*/true);
      conns_.erase(it);
    }
  }

  void HandleReadable(int64_t id, Conn& c) {  // caller holds mu_
    uint8_t chunk[65536];
    for (;;) {
      ssize_t n = read(c.fd, chunk, sizeof(chunk));
      if (n > 0) {
        c.rbuf.insert(c.rbuf.end(), chunk, chunk + n);
        // A short read means the socket buffer is drained — skip the
        // EAGAIN probe (halves read syscalls on small-frame traffic;
        // level-triggered epoll re-arms if more arrives between the
        // short read and the next epoll_wait).
        if (n < static_cast<ssize_t>(sizeof(chunk))) break;
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      c.closed = true;  // EOF or error
      c.err = true;
      break;
    }
    size_t off = 0;
    while (c.rbuf.size() - off >= 4) {
      uint32_t len;
      memcpy(&len, c.rbuf.data() + off, 4);
      len = ntohl(len);
      if (c.rbuf.size() - off - 4 < len) break;
      ready_.push_back(Event{
          id, EV_FRAME,
          std::vector<uint8_t>(c.rbuf.begin() + off + 4,
                               c.rbuf.begin() + off + 4 + len)});
      off += 4 + len;
    }
    if (off) c.rbuf.erase(c.rbuf.begin(), c.rbuf.begin() + off);
  }

  // Writer thread: returns false if the connection died mid-write.
  bool FlushWrites(Conn& c) {  // caller holds mu_
    while (!c.wq.empty()) {
      auto& front = c.wq.front();
      ssize_t n = write(c.fd, front.data() + c.woff, front.size() - c.woff);
      if (n < 0)
        return errno == EAGAIN || errno == EWOULDBLOCK;  // retry on EPOLLOUT
      c.woff += static_cast<size_t>(n);
      if (c.woff == front.size()) {
        c.wq.pop_front();
        c.woff = 0;
      }
    }
    UnwatchWrites(c);  // drained: back to fast-path sends
    return true;
  }

  // Background slow path: completes handshakes and drains queued
  // writes.  Idle connections are not in wepfd_, so a healthy serial
  // RPC workload never wakes this thread.
  void WriterLoop() {
    epoll_event evs[64];
    while (running_) {
      int n = epoll_wait(wepfd_, evs, 64, 200);
      if (!running_) return;
      for (int i = 0; i < n; ++i) {
        uint64_t tag = evs[i].data.u64;
        if (tag == TAG_WAKE) {
          uint64_t junk;
          while (read(wwake_fd_, &junk, sizeof(junk)) > 0) {
          }
          continue;
        }
        bool died = false;
        {
          std::lock_guard<std::mutex> g(mu_);
          auto it = conns_.find(static_cast<int64_t>(tag));
          if (it == conns_.end()) continue;
          Conn& c = it->second;
          if (c.closed) {
            // Level-triggered EPOLLOUT would re-fire every iteration
            // until the poll thread sweeps — drop the watch now or
            // this loop busy-spins while the poller is busy (e.g. a
            // long jit compile inside pump).
            UnwatchWrites(c);
            continue;
          }
          if (c.connecting) {
            int err = 0;
            socklen_t elen = sizeof(err);
            getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &elen);
            if (err != 0) {
              died = true;
            } else {
              c.connecting = false;
            }
          }
          if (!died && !c.connecting) {
            if (c.wq.empty())
              UnwatchWrites(c);
            else if (!FlushWrites(c))
              died = true;
          }
          if (died) {
            c.closed = true;
            c.err = true;
          }
        }
        if (died) WakePoller();  // poller sweeps → EV_CLOSED
      }
    }
  }

  std::atomic<int> spin_us_{0};
  int repfd_ = -1;   // read reactor, run inline by Poll()
  int wepfd_ = -1;   // write/backpressure set, run by the writer thread
  int wake_fd_ = -1;
  int wwake_fd_ = -1;
  int listen_fd_ = -1;
  std::atomic<bool> running_{true};
  std::atomic<int64_t> next_id_{1};
  std::thread writer_;

  std::mutex mu_;  // guards conns_ and every Conn's mutable state
  std::unordered_map<int64_t, Conn> conns_;

  std::deque<Event> ready_;  // poll-thread only: parsed, undelivered events
};

}  // namespace

extern "C" {

void* mrt_create() { return new Transport(); }

void mrt_destroy(void* t) { delete static_cast<Transport*>(t); }

int mrt_listen(void* t, const char* host, int port) {
  return static_cast<Transport*>(t)->Listen(host, port);
}

int64_t mrt_connect(void* t, const char* host, int port) {
  return static_cast<Transport*>(t)->Connect(host, port);
}

int mrt_send(void* t, int64_t conn, const uint8_t* data, uint32_t len) {
  return static_cast<Transport*>(t)->Send(conn, data, len) ? 0 : -1;
}

int mrt_sendv(void* t, int64_t conn, const uint8_t* const* parts,
              const uint32_t* lens, uint32_t nparts) {
  return static_cast<Transport*>(t)->SendV(conn, parts, lens, nparts) ? 0 : -1;
}

void mrt_close(void* t, int64_t conn) {
  static_cast<Transport*>(t)->CloseConn(conn);
}

void mrt_wake(void* t) { static_cast<Transport*>(t)->Wake(); }

void mrt_set_spin(void* t, int us) {
  static_cast<Transport*>(t)->SetSpin(us);
}

int64_t mrt_poll(void* t, int64_t* conn, int* type, uint8_t* buf,
                 uint32_t cap, int timeout_ms) {
  return static_cast<Transport*>(t)->Poll(conn, type, buf, cap, timeout_ms);
}

}  // extern "C"
