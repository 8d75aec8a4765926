// Multi-threaded host job scheduler for Monte-Carlo runs.
//
// The accelerator owns the sim+filter compute; the host runtime around it has
// embarrassingly-parallel work per world — planning-oracle sweeps, CSV/metric
// post-processing, map preprocessing. The reference runs everything single-
// threaded per ROS node; here a shared thread pool executes host jobs across
// cores. Two interfaces, both C-ABI for ctypes:
//
//   * a generic job queue (sched_create/submit/wait/destroy) taking C
//     function-pointer jobs (Python callbacks via ctypes CFUNCTYPE work —
//     ctypes reacquires the GIL inside the callback);
//   * astar_plan_batch: plans many (start, goal) pairs over one occupancy
//     grid in parallel by calling the single-pair reference-semantics
//     astar_plan (astar.cpp, stateless/thread-safe) from the pool.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

extern "C" int astar_plan(const float* occ, int size, int si, int sj, int gi,
                          int gj, int diagonals, int* out, int out_cap);

namespace {

typedef void (*job_fn)(void*);

struct Sched {
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_idle;
  std::deque<std::pair<job_fn, void*>> queue;
  std::vector<std::thread> workers;
  int active = 0;
  bool stop = false;

  explicit Sched(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { run(); });
    }
  }

  void run() {
    for (;;) {
      std::pair<job_fn, void*> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
        active++;
      }
      job.first(job.second);
      {
        std::lock_guard<std::mutex> lk(mu);
        active--;
        if (queue.empty() && active == 0) cv_idle.notify_all();
      }
    }
  }

  ~Sched() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }
};

std::mutex g_mu;
std::map<int64_t, Sched*> g_scheds;
int64_t g_next_handle = 1;

Sched* get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_scheds.find(h);
  return it == g_scheds.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t sched_create(int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  Sched* s = new Sched(n_threads);
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_scheds[h] = s;
  return h;
}

int sched_submit(int64_t h, job_fn fn, void* arg) {
  Sched* s = get(h);
  if (!s || !fn) return 0;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->queue.emplace_back(fn, arg);
  }
  s->cv_work.notify_one();
  return 1;
}

// Block until every submitted job has finished.
void sched_wait(int64_t h) {
  Sched* s = get(h);
  if (!s) return;
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_idle.wait(lk, [s] { return s->queue.empty() && s->active == 0; });
}

void sched_destroy(int64_t h) {
  Sched* s = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_scheds.find(h);
    if (it == g_scheds.end()) return;
    s = it->second;
    g_scheds.erase(it);
  }
  delete s;  // joins workers
}

// Plan n_jobs (start, goal) pairs over one grid in parallel. starts/goals are
// (n_jobs, 2) int32 (i, j); out is (n_jobs, out_stride, 2) int32; out_lens[j]
// receives the path length (or <0 = no path, matching astar_plan).
int astar_plan_batch(const float* occ, int size, const int* starts,
                     const int* goals, int n_jobs, int diagonals,
                     int n_threads, int* out, int out_stride, int* out_lens) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n_jobs) n_threads = n_jobs;
  std::atomic<int> next{0};
  auto worker = [&] {
    int j;
    while ((j = next.fetch_add(1)) < n_jobs) {
      out_lens[j] = astar_plan(
          occ, size, starts[2 * j], starts[2 * j + 1], goals[2 * j],
          goals[2 * j + 1], diagonals,
          out + static_cast<int64_t>(j) * out_stride * 2, out_stride);
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < n_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
