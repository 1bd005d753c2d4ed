// MM and ML tag bodies for every called read of one flush, in one call.
//
// Host code (g++), loaded with ctypes by io/native.py `mm_flush`.  A ctypes
// call runs without the interpreter lock, so the whole flush's sorting and
// delta writing runs beside the engine's other threads.
//
// Input, for n_reads reads of n_ctx contexts each, in read-major order
// (entry e = r * n_ctx + c):
//   seq[seq_off[r], seq_off[r + 1])  read r's native-forward ASCII sequence;
//   counts[e]                        entry e's number of sites;
//   offs, strands                    every entry's read-relative offsets and
//                                    strands (0 forward, else reverse), one
//                                    after another in entry order;
//   probs[prob_at[e] + j]            the u8 probability of entry e's site j.
// Output, per read r:
//   mm[mm_off[r], mm_off[r + 1])     "C+m,<deltas>;G-m,<deltas>;", or nothing
//                                    when the read has no site;
//   ml[ml_off[r], ml_off[r + 1])     the forward calls' probabilities, then
//                                    the reverse calls'.
// Each strand's calls are ordered by offset as a stable sort of the entries'
// calls in context order would order them (the per-read path's
// np.argsort(kind="stable")), and each delta counts the skipped same-base
// positions exactly as bamcore.cpp's hm_mm_deltas does.
//
// Returns the MM bytes written, or -1 - r when read r has a call that does
// not sit on its series base ('C' forward, 'G' reverse) or mm_cap is short.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Call {
    int64_t off;
    uint8_t prob;
};

bool by_offset(const Call& a, const Call& b) { return a.off < b.off; }

// Put `calls[0, runs.back())` in stable offset order: each context's calls
// form a run (they start at runs[0..n_ctx-1]); sorted runs are merged in
// turn (std::merge keeps the first range's element first among equals),
// anything else is stable-sorted.
void order_calls(std::vector<Call>& calls, const std::vector<int64_t>& runs,
                 std::vector<Call>& tmp) {
    const int64_t n = runs.back();
    bool sorted = true;
    for (size_t c = 0; c + 1 < runs.size() && sorted; ++c)
        for (int64_t i = runs[c] + 1; i < runs[c + 1]; ++i)
            if (calls[i - 1].off > calls[i].off) {
                sorted = false;
                break;
            }
    if (!sorted) {
        std::stable_sort(calls.begin(), calls.begin() + n, by_offset);
        return;
    }
    for (size_t c = 2; c < runs.size(); ++c) {
        if (runs[c] == runs[c - 1] || runs[c - 1] == 0) continue;
        std::merge(calls.begin(), calls.begin() + runs[c - 1],
                   calls.begin() + runs[c - 1], calls.begin() + runs[c],
                   tmp.begin(), by_offset);
        std::copy(tmp.begin(), tmp.begin() + runs[c], calls.begin());
    }
}

// cum_c[i], cum_g[i]: the 'C's and 'G's of s[0, i), for i in [0, len].
void base_ranks(const uint8_t* s, int64_t len, std::vector<int32_t>& cum_c,
                std::vector<int32_t>& cum_g) {
    cum_c.resize(len + 1);
    cum_g.resize(len + 1);
    int32_t c = 0, g = 0;
    for (int64_t i = 0; i < len; ++i) {
        cum_c[i] = c;
        cum_g[i] = g;
        c += s[i] == 'C';
        g += s[i] == 'G';
    }
    cum_c[len] = c;
    cum_g[len] = g;
}

// ",d0,d1,..." for the n ordered `calls` on `base` into `out`: each delta
// counts the `base` positions skipped since the previous call (`cum` ranks
// them), which is what hm_mm_deltas's walk writes.  -1 where that walk
// fails: a call off the read, not on `base`, or not after the previous
// one; or `cap` short.
int64_t write_deltas(const uint8_t* seq, int64_t len, uint8_t base,
                     const int32_t* cum, const Call* calls, int64_t n,
                     char* out, int64_t cap) {
    int64_t w = 0, next = 0;
    char tmp[24];
    for (int64_t k = 0; k < n; ++k) {
        const int64_t off = calls[k].off;
        if (off < next || off >= len || seq[off] != base) return -1;
        int64_t v = cum[off] - cum[next], t = 0;
        do { tmp[t++] = (char)('0' + v % 10); v /= 10; } while (v);
        if (w + t + 1 > cap) return -1;
        out[w++] = ',';
        while (t) out[w++] = tmp[--t];
        next = off + 1;
    }
    return w;
}

int64_t put(char* out, int64_t w, int64_t cap, const char* s, int64_t n) {
    if (w < 0 || w + n > cap) return -1;
    std::copy(s, s + n, out + w);
    return w + n;
}

}  // namespace

extern "C" int64_t hm_mm_flush(int64_t n_reads, int64_t n_ctx,
                               const uint8_t* seq, const int64_t* seq_off,
                               const int64_t* offs, const uint8_t* strands,
                               const int64_t* counts, const int64_t* prob_at,
                               const uint8_t* probs,
                               char* mm, int64_t mm_cap, int64_t* mm_off,
                               uint8_t* ml, int64_t* ml_off) {
    std::vector<Call> fwd, rev, tmp;
    std::vector<int32_t> cum_c, cum_g;
    std::vector<int64_t> fwd_runs(n_ctx + 1), rev_runs(n_ctx + 1);
    int64_t w = 0, m = 0, k = 0;
    mm_off[0] = ml_off[0] = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t* cnt = counts + r * n_ctx;
        int64_t total = 0;
        for (int64_t c = 0; c < n_ctx; ++c) total += cnt[c];
        if ((int64_t)fwd.size() < total) {
            fwd.resize(total);
            rev.resize(total);
            tmp.resize(total);
        }
        // split each context's calls by strand, without a branch
        int64_t nf = 0, nr = 0;
        for (int64_t c = 0; c < n_ctx; ++c) {
            fwd_runs[c] = nf;
            rev_runs[c] = nr;
            const uint8_t* p = probs + prob_at[r * n_ctx + c];
            for (int64_t j = 0; j < cnt[c]; ++j, ++k) {
                const Call x{offs[k], p[j]};
                const bool f = strands[k] == 0;
                fwd[nf] = x;
                rev[nr] = x;
                nf += f;
                nr += !f;
            }
        }
        fwd_runs[n_ctx] = nf;
        rev_runs[n_ctx] = nr;
        if (total) {
            order_calls(fwd, fwd_runs, tmp);
            order_calls(rev, rev_runs, tmp);
            const uint8_t* s = seq + seq_off[r];
            const int64_t len = seq_off[r + 1] - seq_off[r];
            base_ranks(s, len, cum_c, cum_g);
            w = put(mm, w, mm_cap, "C+m", 3);
            int64_t d = w < 0 ? -1
                              : write_deltas(s, len, 'C', cum_c.data(),
                                             fwd.data(), nf, mm + w,
                                             mm_cap - w);
            w = d < 0 ? -1 : put(mm, w + d, mm_cap, ";G-m", 4);
            d = w < 0 ? -1
                      : write_deltas(s, len, 'G', cum_g.data(), rev.data(),
                                     nr, mm + w, mm_cap - w);
            w = d < 0 ? -1 : put(mm, w + d, mm_cap, ";", 1);
            if (w < 0) return -1 - r;
            for (int64_t i = 0; i < nf; ++i) ml[m++] = fwd[i].prob;
            for (int64_t i = 0; i < nr; ++i) ml[m++] = rev[i].prob;
        }
        mm_off[r + 1] = w;
        ml_off[r + 1] = m;
    }
    return w;
}
