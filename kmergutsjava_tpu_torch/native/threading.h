// Shared thread-pool helpers for the native components (one copy — the
// three .cpp files each build standalone with g++, so this is a header).
//
// Thread count: KMER_NATIVE_THREADS (values < 1 mean unset), else
// hardware concurrency. Every user preserves output bit-identity at any
// thread count (see each component's header comment).
#pragma once

#include <cstdlib>
#include <thread>
#include <vector>

namespace kmer_native {

inline int num_threads() {
    const char* e = std::getenv("KMER_NATIVE_THREADS");
    if (e) {
        int v = std::atoi(e);
        if (v > 0) return v;
    }
    unsigned hc = std::thread::hardware_concurrency();
    return hc ? (int)hc : 1;
}

// Run fn(t) on T threads (fn(T-1) inline on the caller).
template <typename F>
inline void parallel_for_threads(int T, F&& fn) {
    std::vector<std::thread> ts;
    ts.reserve(T - 1);
    for (int t = 0; t < T - 1; t++) ts.emplace_back(fn, t);
    fn(T - 1);
    for (auto& th : ts) th.join();
}

}  // namespace kmer_native
