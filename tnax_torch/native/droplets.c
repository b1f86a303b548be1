/* Native droplet-store code of the spectrum's host replay
 * (tnax_torch/spectrum.py), a copy of tnax's tnax/native/droplets.c.
 *
 * The droplet (excitation) machinery is host-side pointer-chasing by
 * nature (reference tnac4o/tnac4o.py:2012-2423); this file covers its
 * per-droplet scalar hot loops: Hamming distances, sorted XOR merges,
 * connectivity BFS on adjacency bitsets, the unpack traversal. Pure C with
 * a ctypes binding (tnax_torch/native/__init__.py); the NumPy versions stay
 * in tnax_torch/spectrum.py and run when the caller asks for them.
 *
 * Differences from tnax's copy: u_prune reports a failed allocation, and
 * tnax_unpack_v2 returns -1 for it, where tnax's skipped the pruning; the
 * RMF Hamming distance and the bitset overlap helpers, which the port does
 * not call, are left out.
 *
 * Bitsets are uint64 words, W words per row, the packing of
 * spectrum.adjacency_tables (np.packbits -> view(uint64)).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int popcount64(uint64_t x) {
    return __builtin_popcountll(x);
}

/* Hamming distance between two sorted droplet shapes, Ising semantics:
 * popcount of per-position XOR (reference _exc_hd_comp,
 * tnac4o/tnac4o.py:2152-2177). */
int64_t tnax_hd_pair_ising(const int64_t *p1, const int64_t *s1, int64_t n1,
                           const int64_t *p2, const int64_t *s2, int64_t n2) {
    int64_t i = 0, j = 0, hd = 0;
    while (i < n1 && j < n2) {
        if (p1[i] == p2[j]) {
            hd += popcount64((uint64_t)(s1[i] ^ s2[j]));
            i++; j++;
        } else if (p1[i] < p2[j]) {
            hd += popcount64((uint64_t)s1[i]); i++;
        } else {
            hd += popcount64((uint64_t)s2[j]); j++;
        }
    }
    for (; i < n1; i++) hd += popcount64((uint64_t)s1[i]);
    for (; j < n2; j++) hd += popcount64((uint64_t)s2[j]);
    return hd;
}

/* Hamming distance between two sorted droplet shapes, RMF semantics:
 * the positions where the shapes differ (reference _exc_hd_comp,
 * tnac4o/tnac4o.py:2178-2196). */
int64_t tnax_hd_pair_rmf(const int64_t *p1, const int64_t *s1, int64_t n1,
                         const int64_t *p2, const int64_t *s2, int64_t n2) {
    int64_t i = 0, j = 0, hd = 0;
    while (i < n1 && j < n2) {
        if (p1[i] == p2[j]) {
            if (s1[i] != s2[j]) hd++;
            i++; j++;
        } else if (p1[i] < p2[j]) { hd++; i++; }
        else { hd++; j++; }
    }
    if (i < n1) hd += n1 - i;
    else if (j < n2) hd += n2 - j;
    return hd;
}

/* Sorted-merge XOR of two shapes (reference _exc_merge,
 * tnac4o/tnac4o.py:2198-2247). Output buffers must hold n1+n2 entries;
 * returns the merged length. */
int64_t tnax_merge_shapes(const int64_t *p1, const int64_t *s1, int64_t n1,
                          const int64_t *p2, const int64_t *s2, int64_t n2,
                          int64_t *pos_out, int64_t *st_out) {
    int64_t i = 0, j = 0, k = 0;
    while (i < n1 && j < n2) {
        if (p1[i] == p2[j]) {
            int64_t x = s1[i] ^ s2[j];
            if (x) { pos_out[k] = p1[i]; st_out[k] = x; k++; }
            i++; j++;
        } else if (p1[i] < p2[j]) {
            pos_out[k] = p1[i]; st_out[k] = s1[i]; k++; i++;
        } else {
            pos_out[k] = p2[j]; st_out[k] = s2[j]; k++; j++;
        }
    }
    for (; i < n1; i++, k++) { pos_out[k] = p1[i]; st_out[k] = s1[i]; }
    for (; j < n2; j++, k++) { pos_out[k] = p2[j]; st_out[k] = s2[j]; }
    return k;
}

/* Is the spin set single-connected on the adjacency bitsets? BFS identical
 * to the reference's wave expansion (_exc_elementary,
 * tnac4o/tnac4o.py:2087-2114). adj_bits is (L x W) row-major. */
int tnax_elementary(const uint64_t *adj_bits, int64_t W,
                    const int64_t *spins, int64_t n) {
    if (n <= 1) return 1;
    uint64_t *rest = (uint64_t *)calloc((size_t)W, sizeof(uint64_t));
    int64_t *queue = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    if (!rest || !queue) { free(rest); free(queue); return -1; }
    /* little-endian packing: spin c <-> bit (c & 63) of word (c >> 6),
     * matching spectrum.adjacency_tables's packbits(bitorder="little") */
    for (int64_t i = 1; i < n; i++)
        rest[spins[i] >> 6] |= 1ULL << (spins[i] & 63);
    int64_t head = 0, tail = 0;
    queue[tail++] = spins[0];
    int64_t remaining = n - 1;
    while (head < tail && remaining > 0) {
        const uint64_t *nb = adj_bits + queue[head++] * W;
        for (int64_t w = 0; w < W; w++) {
            uint64_t hit = nb[w] & rest[w];
            if (!hit) continue;
            rest[w] &= ~hit;
            while (hit) {
                int b = __builtin_ctzll(hit);
                queue[tail++] = (w << 6) + b;
                remaining--;
                hit &= hit - 1;
            }
        }
    }
    free(rest);
    free(queue);
    return remaining == 0;
}

/* Expand the flipped-spin ids of a droplet from a CSR view of the
 * xor2ind tables (reference _exc_xor2ind, tnac4o/tnac4o.py:2081-2085):
 * slot = site_base[dpos[t]] + dstate[t]; spins = concat of
 * values[starts[slot]:starts[slot+1]]. Returns the count. */
int64_t tnax_spins(const int64_t *starts, const int64_t *values,
                   const int64_t *site_base, const int64_t *dpos,
                   const int64_t *dstate, int64_t n, int64_t *out) {
    int64_t k = 0;
    for (int64_t t = 0; t < n; t++) {
        int64_t slot = site_base[dpos[t]] + dstate[t];
        int64_t a = starts[slot], b = starts[slot + 1];
        memcpy(out + k, values + a, (size_t)(b - a) * sizeof(int64_t));
        k += b - a;
    }
    return k;
}

/* ------------------------------------------------------------------ */
/* unpack_v2: the decode hot path (reference _exc_unpack_v2,
 * tnac4o/tnac4o.py:2337-2377). The traversal is inherently sequential
 * pointer-chasing over the droplet tree — exactly the reference's
 * algorithm, entry for entry and pop for pop (including its
 * discard-on-reject pop semantics), so the enumerated set matches the
 * Python path state for state; only the machine changes. Pure-Python
 * enumeration at chimera-2048 costs 12-28 s per instance (the spectrum
 * sweep's bottleneck, results/r4_spectrum_L2048.jsonl decode_s); this
 * code runs the identical loop on flat arrays with shared flip chains
 * instead of copied lists.
 *
 * Tree layout (flattened by the Python wrapper in tnax_torch/spectrum.py):
 *   node i: dE[i], key[i] (dictionary key exported in flips),
 *           children = ids child_start[i] .. +child_cnt[i];
 *   roots are ids 0..n_root-1 (the top-level el list, in order);
 *   node_sm / node_nm: per-node spin / adjacency-neighborhood bitsets
 *   (W uint64 words each, same packing as adjacency_tables).
 *
 * Results live in a static store until the next run (host replay is
 * single-threaded): tnax_unpack_v2() returns n_out,
 * tnax_unpack_flip_total() the flattened flip length, and
 * tnax_unpack_fetch() copies Eng / flip offsets / flip keys out.
 */

typedef struct {
    double Eng;
    int64_t flip;     /* id into the flip chain pool, -1 = empty */
    int32_t *pend;    /* pending node ids (own allocation) */
    int64_t pcnt;
} UEntry;

static UEntry *u_entries = NULL;
static int64_t u_n = 0, u_cap = 0;
/* shared-prefix flip chains: (key index, parent chain id) */
static int64_t *u_chain_key = NULL, *u_chain_par = NULL;
static int64_t u_chain_n = 0, u_chain_cap = 0;

static void u_free_all(void) {
    for (int64_t i = 0; i < u_n; i++) free(u_entries[i].pend);
    free(u_entries); u_entries = NULL; u_n = u_cap = 0;
    free(u_chain_key); free(u_chain_par);
    u_chain_key = u_chain_par = NULL; u_chain_n = u_chain_cap = 0;
}

static int u_push_entry(double Eng, int64_t flip, int32_t *pend,
                        int64_t pcnt) {
    if (u_n == u_cap) {
        int64_t nc = u_cap ? 2 * u_cap : 1024;
        UEntry *ne = (UEntry *)realloc(u_entries,
                                       (size_t)nc * sizeof(UEntry));
        if (!ne) return -1;
        u_entries = ne; u_cap = nc;
    }
    u_entries[u_n].Eng = Eng;
    u_entries[u_n].flip = flip;
    u_entries[u_n].pend = pend;
    u_entries[u_n].pcnt = pcnt;
    u_n++;
    return 0;
}

static int64_t u_push_chain(int64_t key, int64_t parent) {
    if (u_chain_n == u_chain_cap) {
        int64_t nc = u_chain_cap ? 2 * u_chain_cap : 4096;
        int64_t *nk = (int64_t *)realloc(u_chain_key,
                                         (size_t)nc * sizeof(int64_t));
        if (!nk) return -2;
        u_chain_key = nk;
        int64_t *np_ = (int64_t *)realloc(u_chain_par,
                                          (size_t)nc * sizeof(int64_t));
        if (!np_) return -2;
        u_chain_par = np_; u_chain_cap = nc;
    }
    u_chain_key[u_chain_n] = key;
    u_chain_par[u_chain_n] = parent;
    return u_chain_n++;
}

/* keep the max_states smallest (Eng, then original index) entries,
 * preserving original order among the kept — quickselect on a scratch
 * index array. Returns 0, or -1 when an allocation fails (nothing is
 * pruned then). */
static int u_prune(int64_t max_states) {
    if (u_n <= max_states) return 0;
    int64_t *idx = (int64_t *)malloc((size_t)u_n * sizeof(int64_t));
    if (!idx) return -1;
    for (int64_t i = 0; i < u_n; i++) idx[i] = i;
    int64_t lo = 0, hi = u_n - 1, k = max_states;
    while (lo < hi) {
        /* median-of-three pivot on (Eng, idx) */
        int64_t mid = lo + (hi - lo) / 2;
        double pe = u_entries[idx[mid]].Eng;
        int64_t pi = idx[mid];
        int64_t i = lo, j = hi;
        while (i <= j) {
            while (u_entries[idx[i]].Eng < pe
                   || (u_entries[idx[i]].Eng == pe && idx[i] < pi)) i++;
            while (u_entries[idx[j]].Eng > pe
                   || (u_entries[idx[j]].Eng == pe && idx[j] > pi)) j--;
            if (i <= j) {
                int64_t t = idx[i]; idx[i] = idx[j]; idx[j] = t;
                i++; j--;
            }
        }
        if (k <= j) hi = j;
        else if (k >= i) lo = i;
        else break;
    }
    /* keep mask from the first k slots */
    char *keep = (char *)calloc((size_t)u_n, 1);
    if (!keep) { free(idx); return -1; }
    for (int64_t i = 0; i < k; i++) keep[idx[i]] = 1;
    int64_t w = 0;
    for (int64_t i = 0; i < u_n; i++) {
        if (keep[i]) u_entries[w++] = u_entries[i];
        else free(u_entries[i].pend);
    }
    u_n = w;
    free(idx); free(keep);
    return 0;
}

int64_t tnax_unpack_v2(const double *node_dE, const int64_t *node_key,
                       const int64_t *child_start, const int64_t *child_cnt,
                       const uint64_t *node_sm, const uint64_t *node_nm,
                       int64_t W, int64_t n_nodes, int64_t n_root,
                       double max_dEng, int64_t max_states, int one_layer) {
    (void)n_nodes;
    u_free_all();
    /* root entry: Eng 0, empty flip, pending = roots in order (pops take
     * the back first, matching Python's list.pop()) */
    int32_t *rp = NULL;
    if (n_root) {
        rp = (int32_t *)malloc((size_t)n_root * sizeof(int32_t));
        if (!rp) return -1;
        for (int64_t i = 0; i < n_root; i++) rp[i] = (int32_t)i;
    }
    if (u_push_entry(0.0, -1, rp, n_root)) { free(rp); return -1; }

    int progressed = 1;
    while (progressed) {
        progressed = 0;
        for (int64_t kk = 0; kk < u_n; kk++) {
            if (!u_entries[kk].pcnt) continue;
            int32_t node = u_entries[kk].pend[--u_entries[kk].pcnt];
            double E2 = u_entries[kk].Eng + node_dE[node];
            if (E2 > max_dEng) continue;
            int64_t fl = u_push_chain(node_key[node], u_entries[kk].flip);
            if (fl < 0) { u_free_all(); return -1; }
            /* rest = pending (post-pop) filtered by the accepted node's
             * neighborhood, then the node's children appended */
            const uint64_t *nm = node_nm + (int64_t)node * W;
            int64_t pc = u_entries[kk].pcnt;
            int64_t nch = one_layer ? 0 : child_cnt[node];
            int32_t *np2 = (int32_t *)malloc(
                (size_t)(pc + nch > 0 ? pc + nch : 1) * sizeof(int32_t));
            if (!np2) { u_free_all(); return -1; }
            int64_t w2 = 0;
            for (int64_t t = 0; t < pc; t++) {
                int32_t x = u_entries[kk].pend[t];
                const uint64_t *sm = node_sm + (int64_t)x * W;
                int hit = 0;
                for (int64_t w = 0; w < W; w++)
                    if (nm[w] & sm[w]) { hit = 1; break; }
                if (!hit) np2[w2++] = x;
            }
            for (int64_t c = 0; c < nch; c++)
                np2[w2++] = (int32_t)(child_start[node] + c);
            if (u_push_entry(E2, fl, np2, w2)) {
                free(np2); u_free_all(); return -1;
            }
            progressed = 1;
        }
        if (u_prune(max_states)) { u_free_all(); return -1; }
    }
    return u_n;
}

int64_t tnax_unpack_flip_total(void) {
    int64_t total = 0;
    for (int64_t i = 0; i < u_n; i++)
        for (int64_t f = u_entries[i].flip; f >= 0; f = u_chain_par[f])
            total++;
    return total;
}

/* Eng_out[n], flip_off[n+1] (prefix offsets), flip_keys[total]; flips are
 * emitted root-first (the order Python builds flip[kk] + [key]). */
void tnax_unpack_fetch(double *Eng_out, int64_t *flip_off,
                       int64_t *flip_keys) {
    int64_t off = 0;
    for (int64_t i = 0; i < u_n; i++) {
        Eng_out[i] = u_entries[i].Eng;
        flip_off[i] = off;
        int64_t depth = 0;
        for (int64_t f = u_entries[i].flip; f >= 0; f = u_chain_par[f])
            depth++;
        for (int64_t f = u_entries[i].flip, d = depth - 1; f >= 0;
             f = u_chain_par[f], d--)
            flip_keys[off + d] = u_chain_key[f];
        off += depth;
    }
    flip_off[u_n] = off;
    u_free_all();
}

/* Batched elementary test: for each of n droplets (CSR rows of block-site
 * flips, bounds[t]..bounds[t+1] into dpos/dstate), expand the flipped
 * spins via the xor2ind CSR (as tnax_spins) and run the connectivity BFS
 * (as tnax_elementary) — one call per lattice site instead of two ctypes
 * calls per loser. out[t] = 0/1; returns -1 on allocation failure. */
int tnax_elem_batch(const int64_t *starts, const int64_t *values,
                    const int64_t *site_base, const uint64_t *adj_bits,
                    int64_t W, const int64_t *dpos, const int64_t *dstate,
                    const int64_t *bounds, int64_t n, int64_t max_spins,
                    int64_t *out) {
    uint64_t *rest = (uint64_t *)malloc((size_t)W * sizeof(uint64_t));
    int64_t *spins = (int64_t *)malloc((size_t)max_spins * sizeof(int64_t));
    int64_t *queue = (int64_t *)malloc((size_t)max_spins * sizeof(int64_t));
    if (!rest || !spins || !queue) {
        free(rest); free(spins); free(queue); return -1;
    }
    for (int64_t t = 0; t < n; t++) {
        int64_t k = 0;
        for (int64_t u = bounds[t]; u < bounds[t + 1]; u++) {
            int64_t slot = site_base[dpos[u]] + dstate[u];
            int64_t a = starts[slot], b = starts[slot + 1];
            memcpy(spins + k, values + a, (size_t)(b - a) * sizeof(int64_t));
            k += b - a;
        }
        if (k <= 1) { out[t] = 1; continue; }
        memset(rest, 0, (size_t)W * sizeof(uint64_t));
        for (int64_t i = 1; i < k; i++)
            rest[spins[i] >> 6] |= 1ULL << (spins[i] & 63);
        int64_t head = 0, tail = 0;
        queue[tail++] = spins[0];
        int64_t remaining = k - 1;
        while (head < tail && remaining > 0) {
            const uint64_t *nb = adj_bits + queue[head++] * W;
            for (int64_t w = 0; w < W; w++) {
                uint64_t hit = nb[w] & rest[w];
                if (!hit) continue;
                rest[w] &= ~hit;
                while (hit) {
                    int b = __builtin_ctzll(hit);
                    queue[tail++] = (w << 6) + b;
                    remaining--;
                    hit &= hit - 1;
                }
            }
        }
        out[t] = remaining == 0;
    }
    free(rest); free(spins); free(queue);
    return 0;
}
