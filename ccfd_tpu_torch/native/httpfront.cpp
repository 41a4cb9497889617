// Native HTTP serving front: request parsing, payload decode, and response
// writing in C++ threads; Python touches only whole scoring batches.
//
// The port's copy of ccfd_tpu/native/httpfront.cpp, without the reference's
// in-front host model (small requests scored in the IO thread on a host copy
// of the params): every canonical predict request goes to the Python takers,
// and so to the kernel.
//
// Why: the REST hop's per-request Python cost (~650us: header parse, JSON,
// future/condvar hand-off, response build) is GIL-serialized, capping the
// Seldon-contract endpoint at a few thousand req/s regardless of how fast
// the TPU scores (SURVEY.md §7 "hard parts (a)": p99 <10ms with Python on
// the hot path needs a native decode/batch shim). This front moves the
// whole per-request path into C++:
//
//   epoll IO thread: accept, parse HTTP/1.1 keep-alive, auth-check,
//     decode the canonical Seldon ndarray payload (ccfd_decode_ndarray,
//     decode.cpp) into a float32 row block, enqueue.
//   Python scorer threads: ccfd_front_take() -> ONE batch of concatenated
//     rows across many requests -> scorer.score -> ccfd_front_respond().
//   C++ formats the {"data":{"names":...,"ndarray":[[p0,p1],...]}} body
//     and the IO thread writes it back.
//
// Requests C++ can't finish (non-canonical payloads, GET /prometheus,
// bad JSON) queue as "misc" and a Python thread answers them through the
// same routing logic the pure-Python server uses — identical contract,
// different fast path. The wire format matches serving/server.py exactly.
//
// Concurrency model: ONE IO thread owns every socket (no per-socket
// locking); scorer/misc threads only touch the two queues + response
// queue, all under one mutex; an eventfd wakes the IO thread to flush
// responses. Connection death with in-flight requests is handled by a
// (fd, generation) check at response time.

// epoll/eventfd are Linux-only; on other platforms the front degrades to
// stubs (create returns nullptr, and serving/native_front.py raises)
// WITHOUT poisoning the shared .so build for decode/log acceleration.
#ifdef __linux__

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" int ccfd_decode_ndarray(const char* buf, size_t len, float* out,
                                   int max_rows, int n_features,
                                   int* width_out);

namespace {

constexpr size_t kMaxHead = 64 * 1024;
constexpr size_t kMaxBody = 256 * 1024 * 1024;
// Native-path row cap per request: anything larger routes to the misc
// (Python) queue so one giant request can never exceed the taker's batch
// buffer and wedge the predict queue head. The Python taker's buffer
// (serving/native_front.py max_batch_rows) must be >= this.
constexpr int kNativeMaxRows = 8192;

struct Conn {
  std::string in;
  std::string out;
  uint64_t gen = 0;
  bool want_close = false;
  bool read_closed = false;  // peer half-closed: EOF is permanently readable
  int pending = 0;  // requests enqueued to Python, response not yet queued
};

struct PredictReq {
  int id;
  int fd;
  uint64_t gen;
  int n_rows;
  int path_tag;  // 0 = .../predictions, 1 = /predict (metrics label)
  std::vector<float> rows;
  double enq_monotonic_ms;
};

struct MiscReq {
  int id;
  int fd;
  uint64_t gen;
  std::string method;
  std::string path;
  std::string body;
};

struct Response {
  int fd;
  uint64_t gen;
  std::string data;
};

struct Front {
  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_fd = -1;
  int port = 0;
  int n_features = 30;
  std::string auth;  // "Bearer <token>"; empty = no auth
  std::thread io_thread;
  bool stopping = false;

  std::mutex mu;
  std::condition_variable cv;  // signals scorer/misc threads
  std::deque<PredictReq> predict_q;
  std::deque<MiscReq> misc_q;
  std::deque<Response> resp_q;  // drained by the IO thread
  std::unordered_map<int, std::pair<uint64_t, int>> req_route;  // id -> (gen, fd)
  int next_id = 1;
  uint64_t gen_counter = 1;
  std::unordered_map<int, Conn> conns;

  // stats (read via ccfd_front_stats)
  long n_requests = 0;
  long n_predict = 0;
  long n_misc = 0;
  long n_auth_fail = 0;
};

double now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

void set_nonblock(int fd) {
  // O_NONBLOCK via ioctl-free fcntl
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

const char* reason_of(int status) {
  switch (status) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 401: return "Unauthorized";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 413: return "Payload Too Large";
    default: return "Internal Server Error";
  }
}

// Seldon predict response body: {"data": {...}, "meta": {...}} — the wire
// format serving/server.py and ccfd_front_respond produce, byte-compatible.
std::string format_predict_body(const float* probas, int rows,
                                const char* model) {
  std::string body;
  body.reserve(64 + static_cast<size_t>(rows) * 48);
  body += "{\"data\": {\"names\": [\"proba_0\", \"proba_1\"], \"ndarray\": [";
  char num[64];
  for (int r = 0; r < rows; ++r) {
    double p = static_cast<double>(probas[r]);
    if (r) body += ", ";
    snprintf(num, sizeof(num), "[%.17g, %.17g]", 1.0 - p, p);
    body += num;
  }
  body += "]}, \"meta\": {\"model\": \"";
  body += model;
  body += "\"}}";
  return body;
}

std::string make_response(int status, const char* ctype, const char* body,
                          size_t body_len) {
  char head[256];
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                   "Content-Length: %zu\r\n\r\n",
                   status, reason_of(status), ctype, body_len);
  std::string out;
  out.reserve(n + body_len);
  out.append(head, n);
  out.append(body, body_len);
  return out;
}

void queue_write(Front* f, int fd, std::string data);  // fwd

// Locking discipline: every function below (handle_one_request,
// queue_write, flush_conn, close_conn) REQUIRES f->mu held by the caller
// — std::mutex is non-recursive, so nothing here may lock it again.

// Parse one complete request out of c->in; returns false if incomplete.
bool handle_one_request(Front* f, int fd, Conn* c) {
  size_t head_end = c->in.find("\r\n\r\n");
  if (head_end == std::string::npos) {
    if (c->in.size() > kMaxHead) {
      queue_write(f, fd, make_response(400, "text/plain", "head too large", 14));
      c->want_close = true;
    }
    return false;
  }
  // request line
  size_t line_end = c->in.find("\r\n");
  std::string line = c->in.substr(0, line_end);
  size_t sp1 = line.find(' ');
  size_t sp2 = line.find(' ', sp1 + 1);
  if (sp1 == std::string::npos) {
    queue_write(f, fd, make_response(400, "text/plain", "bad request line", 16));
    c->want_close = true;
    return false;
  }
  std::string method = line.substr(0, sp1);
  std::string path = sp2 == std::string::npos ? line.substr(sp1 + 1)
                                              : line.substr(sp1 + 1, sp2 - sp1 - 1);
  // headers we care about: content-length, authorization, connection
  size_t content_length = 0;
  std::string auth_header;
  bool close_conn = false;
  size_t pos = line_end + 2;
  while (pos < head_end) {
    size_t eol = c->in.find("\r\n", pos);
    if (eol == std::string::npos || eol > head_end) eol = head_end;
    size_t colon = c->in.find(':', pos);
    if (colon != std::string::npos && colon < eol) {
      std::string key = c->in.substr(pos, colon - pos);
      for (auto& ch : key) ch = tolower(ch);
      size_t vstart = colon + 1;
      while (vstart < eol && (c->in[vstart] == ' ' || c->in[vstart] == '\t'))
        ++vstart;
      std::string val = c->in.substr(vstart, eol - vstart);
      while (!val.empty() && (val.back() == ' ' || val.back() == '\t'))
        val.pop_back();  // trailing OWS is legal in a field line (RFC 9110)
      if (key == "content-length") {
        // a non-numeric length silently read as 0 would leave the body
        // bytes in the buffer to be parsed as the NEXT request line —
        // reject like the Python transport does
        char* endp = nullptr;
        content_length = strtoul(val.c_str(), &endp, 10);
        if (val.empty() || endp == val.c_str() || *endp != '\0') {
          queue_write(f, fd,
                      make_response(400, "text/plain", "bad content-length", 18));
          c->want_close = true;
          return false;
        }
      } else if (key == "authorization") {
        auth_header = val;
      } else if (key == "connection") {
        for (auto& ch : val) ch = tolower(ch);
        close_conn = (val == "close");
      }
    }
    pos = eol + 2;
  }
  if (content_length > kMaxBody) {
    queue_write(f, fd, make_response(413, "text/plain", "body too large", 14));
    c->want_close = true;
    return false;
  }
  size_t total = head_end + 4 + content_length;
  if (c->in.size() < total) return false;  // body incomplete
  std::string body = c->in.substr(head_end + 4, content_length);
  c->in.erase(0, total);
  if (close_conn) c->want_close = true;
  ++f->n_requests;

  // auth gate (Seldon bearer token, reference README.md:372-384)
  if (!f->auth.empty() && method == "POST" && auth_header != f->auth) {
    ++f->n_auth_fail;
    const char* msg = "{\"error\": \"unauthorized\"}";
    queue_write(f, fd, make_response(401, "application/json", msg, strlen(msg)));
    return true;
  }

  bool is_predict_path = false;
  int path_tag = 0;
  {
    std::string p = path;
    while (!p.empty() && p.back() == '/') p.pop_back();
    is_predict_path =
        (p.size() >= 12 && p.compare(p.size() - 12, 12, "/predictions") == 0) ||
        p == "/predict";
    if (p == "/predict") path_tag = 1;
  }
  if (method == "POST" && is_predict_path) {
    // canonical payload -> native decode -> the predict queue for Python/
    // device scoring; anything odd (and anything over the native row cap)
    // falls through to Python via the misc queue (exact-contract replies)
    double t0 = now_ms();
    std::vector<float> rows;
    int est = 0;
    for (char ch : body)
      if (ch == '[') ++est;
    if (est > 0 && est <= kNativeMaxRows + 1) {
      rows.resize(static_cast<size_t>(est) * f->n_features);
      int width = 0;
      int n = ccfd_decode_ndarray(body.data(), body.size(), rows.data(), est,
                                  f->n_features, &width);
      if (n >= 0 && n <= kNativeMaxRows) {
        rows.resize(static_cast<size_t>(n) * f->n_features);
        int id = f->next_id++;
        f->req_route[id] = {c->gen, fd};
        f->predict_q.push_back(
            {id, fd, c->gen, n, path_tag, std::move(rows), t0});
        ++f->n_predict;
        ++c->pending;  // a Connection:close conn must outlive its answers
        f->cv.notify_all();
        return true;
      }
    }
  }
  // misc: Python answers through the shared routing logic
  int id = f->next_id++;
  f->req_route[id] = {c->gen, fd};
  f->misc_q.push_back({id, fd, c->gen, method, path, std::move(body)});
  ++f->n_misc;
  ++c->pending;
  f->cv.notify_all();
  return true;
}

void queue_write(Front* f, int fd, std::string data) {
  auto it = f->conns.find(fd);
  if (it == f->conns.end()) return;
  it->second.out += data;
}

void flush_conn(Front* f, int fd, Conn* c) {
  while (!c->out.empty()) {
    ssize_t n = send(fd, c->out.data(), c->out.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->out.erase(0, n);
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      // wait for EPOLLOUT; a half-closed conn must not re-arm EPOLLIN
      // here either (its EOF level-triggers forever -> busy spin)
      struct epoll_event ev;
      ev.events = EPOLLOUT | (c->read_closed ? 0 : EPOLLIN);
      ev.data.fd = fd;
      epoll_ctl(f->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
      return;
    } else {
      c->want_close = true;
      return;
    }
  }
  struct epoll_event ev;
  // a half-closed conn must NOT re-arm EPOLLIN: its EOF is permanently
  // readable and would spin the loop until teardown
  ev.events = c->read_closed ? 0 : EPOLLIN;
  ev.data.fd = fd;
  epoll_ctl(f->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
}

void close_conn(Front* f, int fd) {
  f->conns.erase(fd);
  epoll_ctl(f->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
}

void io_loop(Front* f) {
  struct epoll_event evs[128];
  while (true) {
    int n = epoll_wait(f->epoll_fd, evs, 128, 200);
    {
      std::lock_guard<std::mutex> lk(f->mu);
      if (f->stopping) return;
      // drain responses queued by scorer/misc threads
      while (!f->resp_q.empty()) {
        Response r = std::move(f->resp_q.front());
        f->resp_q.pop_front();
        auto it = f->conns.find(r.fd);
        if (it == f->conns.end() || it->second.gen != r.gen) continue;
        it->second.out += r.data;
        if (it->second.pending > 0) --it->second.pending;
        // the connection is serialized (one Python-bound request in
        // flight keeps HTTP/1.1 responses in request order): now that
        // its answer is queued, parse any requests buffered behind it
        while (it->second.pending == 0 &&
               handle_one_request(f, r.fd, &it->second)) {
        }
      }
    }
    for (int i = 0; i < n; ++i) {
      int fd = evs[i].data.fd;
      if (fd == f->wake_fd) {
        uint64_t junk;
        while (read(f->wake_fd, &junk, 8) == 8) {
        }
        continue;
      }
      if (fd == f->listen_fd) {
        while (true) {
          int cfd = accept(f->listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          set_nonblock(cfd);
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          struct epoll_event ev;
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(f->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
          std::lock_guard<std::mutex> lk(f->mu);
          Conn c;
          c.gen = f->gen_counter++;
          f->conns.emplace(cfd, std::move(c));
        }
        continue;
      }
      auto it = f->conns.find(fd);
      if (it == f->conns.end()) continue;
      Conn* c = &it->second;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        std::lock_guard<std::mutex> lk(f->mu);
        close_conn(f, fd);
        continue;
      }
      if (evs[i].events & EPOLLIN) {
        char buf[1 << 16];
        bool peer_closed = false;
        while (true) {
          ssize_t r = recv(fd, buf, sizeof(buf), 0);
          if (r > 0) {
            c->in.append(buf, r);
            if (c->in.size() > kMaxBody + kMaxHead) {
              c->want_close = true;
              break;
            }
          } else if (r == 0) {
            peer_closed = true;
            break;
          } else {
            break;  // EAGAIN or error
          }
        }
        {
          std::lock_guard<std::mutex> lk(f->mu);
          // serialize per connection: HTTP/1.1 requires responses in
          // request order, and Python-bound requests complete out of
          // order across the scorer/misc queues — so at most ONE is in
          // flight per connection; buffered pipelined requests parse
          // when its response drains (see resp_q loop)
          while (c->pending == 0 && handle_one_request(f, fd, c)) {
          }
        }
        if (peer_closed) {
          std::lock_guard<std::mutex> lk(f->mu);
          auto itc = f->conns.find(fd);
          if (itc == f->conns.end()) continue;
          // a half-closing client (shutdown(SHUT_WR) after the request)
          // still expects its response: defer teardown to the pending/
          // flush machinery; stop watching EPOLLIN so the permanently
          // readable EOF doesn't spin the loop
          itc->second.want_close = true;
          itc->second.read_closed = true;
          if (itc->second.pending == 0 && itc->second.out.empty()) {
            close_conn(f, fd);
          } else {
            // stop monitoring entirely while the response is produced:
            // EPOLLIN would fire forever on the EOF, and EPOLLOUT fires
            // immediately on an empty out buffer — either way a busy
            // spin. The resp-drain flush sweep delivers the answer.
            struct epoll_event ev;
            ev.events = 0;
            ev.data.fd = fd;
            epoll_ctl(f->epoll_fd, EPOLL_CTL_MOD, fd, &ev);
          }
          continue;
        }
      }
      {
        std::lock_guard<std::mutex> lk(f->mu);
        auto it2 = f->conns.find(fd);
        if (it2 == f->conns.end()) continue;
        flush_conn(f, fd, &it2->second);
        if (it2->second.want_close && it2->second.out.empty() &&
            it2->second.pending == 0)
          close_conn(f, fd);
      }
    }
    // flush conns that got responses but no epoll event this round, and
    // retire Connection:close conns whose last pending answer just left
    std::lock_guard<std::mutex> lk(f->mu);
    std::vector<int> done;
    for (auto& kv : f->conns) {
      if (!kv.second.out.empty()) flush_conn(f, kv.first, &kv.second);
      if (kv.second.want_close && kv.second.out.empty() &&
          kv.second.pending == 0)
        done.push_back(kv.first);
    }
    for (int fd : done) close_conn(f, fd);
  }
}

}  // namespace

extern "C" {

void* ccfd_front_create(const char* host, int port, int n_features,
                        const char* auth_token, int* port_out) {
  Front* f = new Front();
  f->n_features = n_features;
  if (auth_token != nullptr && auth_token[0] != '\0')
    f->auth = std::string("Bearer ") + auth_token;
  f->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (f->listen_fd < 0) {
    delete f;
    return nullptr;
  }
  int one = 1;
  setsockopt(f->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  if (host != nullptr && host[0] != '\0' &&
      strcmp(host, "0.0.0.0") != 0) {
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      close(f->listen_fd);
      delete f;
      return nullptr;  // unparseable bind host: the caller raises
    }
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(f->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(f->listen_fd, 256) < 0) {
    close(f->listen_fd);
    delete f;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(f->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  f->port = ntohs(addr.sin_port);
  if (port_out != nullptr) *port_out = f->port;
  set_nonblock(f->listen_fd);
  f->epoll_fd = epoll_create1(0);
  f->wake_fd = eventfd(0, EFD_NONBLOCK);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.fd = f->listen_fd;
  epoll_ctl(f->epoll_fd, EPOLL_CTL_ADD, f->listen_fd, &ev);
  ev.data.fd = f->wake_fd;
  epoll_ctl(f->epoll_fd, EPOLL_CTL_ADD, f->wake_fd, &ev);
  f->io_thread = std::thread(io_loop, f);
  return f;
}

// Dequeue up to max_reqs predict requests / max_rows total rows as ONE
// concatenated row block. meta_out: [id, n_rows, path_tag] per request;
// enq_ms_out: per-request enqueue timestamps (CLOCK_MONOTONIC ms).
// Returns the number of requests (0 on timeout, -1 when stopping).
int ccfd_front_take(void* h, float* rows_out, int max_rows, int* meta_out,
                    double* enq_ms_out, int max_reqs, int timeout_ms) {
  Front* f = static_cast<Front*>(h);
  std::unique_lock<std::mutex> lk(f->mu);
  if (f->predict_q.empty()) {
    f->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                   [f] { return f->stopping || !f->predict_q.empty(); });
  }
  if (f->stopping) return -1;
  int n_reqs = 0;
  int rows_used = 0;
  while (!f->predict_q.empty() && n_reqs < max_reqs) {
    PredictReq& r = f->predict_q.front();
    if (rows_used + r.n_rows > max_rows) {
      if (n_reqs == 0) {
        // defensive: a request bigger than the taker's whole buffer
        // (impossible while kNativeMaxRows <= the taker's max_rows, but
        // a misconfigured caller must not wedge the queue head) — fail
        // it rather than starve everything behind it
        const char* msg = "{\"error\": \"request exceeds native batch\"}";
        Response resp;
        resp.data = make_response(500, "application/json", msg, strlen(msg));
        auto it = f->req_route.find(r.id);
        if (it != f->req_route.end()) {
          resp.gen = it->second.first;
          resp.fd = it->second.second;
          f->req_route.erase(it);
          f->resp_q.push_back(std::move(resp));
        }
        f->predict_q.pop_front();
        continue;
      }
      break;
    }
    memcpy(rows_out + static_cast<size_t>(rows_used) * f->n_features,
           r.rows.data(), r.rows.size() * sizeof(float));
    meta_out[3 * n_reqs] = r.id;
    meta_out[3 * n_reqs + 1] = r.n_rows;
    meta_out[3 * n_reqs + 2] = r.path_tag;
    enq_ms_out[n_reqs] = r.enq_monotonic_ms;
    rows_used += r.n_rows;
    ++n_reqs;
    f->predict_q.pop_front();
  }
  return n_reqs;
}

// Respond to previously taken predict requests: probas holds one float per
// row in take() order; C++ formats the Seldon response body per request.
void ccfd_front_respond(void* h, const int* req_ids, const int* row_counts,
                        int n_reqs, const float* probas, const char* model) {
  Front* f = static_cast<Front*>(h);
  int off = 0;
  std::vector<Response> ready;
  ready.reserve(n_reqs);
  for (int i = 0; i < n_reqs; ++i) {
    int rows = row_counts[i];
    std::string body = format_predict_body(probas + off, rows, model);
    off += rows;
    Response resp;
    resp.data = make_response(200, "application/json", body.data(), body.size());
    ready.push_back(std::move(resp));
  }
  {
    std::lock_guard<std::mutex> lk(f->mu);
    for (int i = 0; i < n_reqs; ++i) {
      auto it = f->req_route.find(req_ids[i]);
      if (it == f->req_route.end()) continue;
      ready[i].gen = it->second.first;
      ready[i].fd = it->second.second;
      f->req_route.erase(it);
      f->resp_q.push_back(std::move(ready[i]));
    }
  }
  uint64_t one = 1;
  ssize_t ignored = write(f->wake_fd, &one, 8);
  (void)ignored;
}

// Nonblocking take of one misc request (GET /prometheus, non-canonical
// POST bodies, ...). Returns req id (>0), 0 if none, -1 when stopping.
// method/path copy into fixed buffers; body via a malloc'd pointer the
// caller frees with ccfd_front_free.
int ccfd_front_take_misc(void* h, char* method_out, int method_cap,
                         char* path_out, int path_cap, char** body_out,
                         int* body_len_out, int timeout_ms) {
  Front* f = static_cast<Front*>(h);
  std::unique_lock<std::mutex> lk(f->mu);
  if (f->misc_q.empty()) {
    f->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                   [f] { return f->stopping || !f->misc_q.empty(); });
  }
  if (f->stopping) return -1;
  if (f->misc_q.empty()) return 0;
  MiscReq r = std::move(f->misc_q.front());
  f->misc_q.pop_front();
  snprintf(method_out, method_cap, "%s", r.method.c_str());
  snprintf(path_out, path_cap, "%s", r.path.c_str());
  char* body = static_cast<char*>(malloc(r.body.size() + 1));
  memcpy(body, r.body.data(), r.body.size());
  body[r.body.size()] = '\0';
  *body_out = body;
  *body_len_out = static_cast<int>(r.body.size());
  return r.id;
}

void ccfd_front_free(char* p) { free(p); }

void ccfd_front_respond_misc(void* h, int req_id, int status,
                             const char* ctype, const char* body,
                             int body_len) {
  Front* f = static_cast<Front*>(h);
  Response resp;
  resp.data = make_response(status, ctype, body, body_len);
  {
    std::lock_guard<std::mutex> lk(f->mu);
    auto it = f->req_route.find(req_id);
    if (it == f->req_route.end()) return;
    resp.gen = it->second.first;
    resp.fd = it->second.second;
    f->req_route.erase(it);
    f->resp_q.push_back(std::move(resp));
  }
  uint64_t one = 1;
  ssize_t ignored = write(f->wake_fd, &one, 8);
  (void)ignored;
}

void ccfd_front_stats(void* h, long* out4) {
  Front* f = static_cast<Front*>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  out4[0] = f->n_requests;
  out4[1] = f->n_predict;
  out4[2] = f->n_misc;
  out4[3] = f->n_auth_fail;
}

// Stop serving: wakes takers (they return -1) and joins the IO thread,
// but does NOT free the Front — Python threads may still be inside
// take()/take_misc() on this pointer. The caller joins its worker
// threads and then calls ccfd_front_destroy.
void ccfd_front_stop(void* h) {
  Front* f = static_cast<Front*>(h);
  {
    std::lock_guard<std::mutex> lk(f->mu);
    f->stopping = true;
    f->cv.notify_all();
  }
  uint64_t one = 1;
  ssize_t ignored = write(f->wake_fd, &one, 8);
  (void)ignored;
  if (f->io_thread.joinable()) f->io_thread.join();
  {
    std::lock_guard<std::mutex> lk(f->mu);
    for (auto& kv : f->conns) close(kv.first);
    f->conns.clear();
  }
  close(f->listen_fd);
  // epoll_fd/wake_fd stay OPEN until destroy: a worker wedged inside a
  // device dispatch may still call respond() after stop(), and writing
  // the wake token to a closed (possibly REUSED) fd would inject bytes
  // into an unrelated stream. An unread eventfd write is harmless.
}

void ccfd_front_destroy(void* h) {
  Front* f = static_cast<Front*>(h);
  close(f->epoll_fd);
  close(f->wake_fd);
  delete f;
}

}  // extern "C"

#else  // !__linux__: stubs — native front unavailable, Python transport used

#include <cstddef>
#include <cstdint>

extern "C" {

void* ccfd_front_create(const char*, int, int, const char*, int*) {
  return nullptr;
}
int ccfd_front_take(void*, float*, int, int*, double*, int, int) { return -1; }
void ccfd_front_respond(void*, const int*, const int*, int, const float*,
                        const char*) {}
int ccfd_front_take_misc(void*, char*, int, char*, int, char**, int*, int) {
  return -1;
}
void ccfd_front_free(char*) {}
void ccfd_front_respond_misc(void*, int, int, const char*, const char*, int) {}
void ccfd_front_stats(void*, long* out4) {
  out4[0] = out4[1] = out4[2] = out4[3] = 0;
}
void ccfd_front_stop(void*) {}
void ccfd_front_destroy(void*) {}

}  // extern "C"

#endif  // __linux__
