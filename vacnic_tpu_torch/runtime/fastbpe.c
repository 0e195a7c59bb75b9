/* fastbpe.c — byte-pair-encoding merge loop, the hot host-side op of the
 * data pipeline (tokenizing 512-token articles per sample).
 *
 * The Python tokenizer (data/tokenize.py) maps a pre-token to initial symbol
 * ids and hands this routine:
 *   - syms[n]: the word's current symbol ids,
 *   - a sorted table of (pair_key -> rank, merged_id) where
 *     pair_key = (uint64)a << 32 | b.
 * The routine repeatedly merges the lowest-rank adjacent pair in place and
 * returns the final symbol count. Pure C99, no CPython API — bound via
 * ctypes (vacnic_tpu_torch/runtime/native.py).
 *
 * Build: cc -O2 -shared -fPIC fastbpe.c -o libfastbpe.so
 */

#include <stdint.h>
#include <stddef.h>

/* binary search over sorted pair keys; returns index or -1 */
static int64_t find_pair(const uint64_t *keys, int64_t n, uint64_t key) {
    int64_t lo = 0, hi = n - 1;
    while (lo <= hi) {
        int64_t mid = lo + (hi - lo) / 2;
        if (keys[mid] == key) return mid;
        if (keys[mid] < key) lo = mid + 1; else hi = mid - 1;
    }
    return -1;
}

/* Merge loop. syms: int32 buffer of length *n_inout (modified in place).
 * keys/ranks/merged: the merge table (n_table entries, keys ascending).
 * Returns 0 on success. */
int bpe_encode_word(
    int32_t *syms, int32_t *n_inout,
    const uint64_t *keys, const int32_t *ranks, const int32_t *merged,
    int64_t n_table)
{
    int32_t n = *n_inout;
    while (n > 1) {
        /* find the adjacent pair with the lowest rank */
        int32_t best_i = -1;
        int32_t best_rank = 0x7fffffff;
        int64_t best_tbl = -1;
        for (int32_t i = 0; i + 1 < n; i++) {
            uint64_t key = ((uint64_t)(uint32_t)syms[i] << 32) | (uint32_t)syms[i + 1];
            int64_t at = find_pair(keys, n_table, key);
            if (at >= 0 && ranks[at] < best_rank) {
                best_rank = ranks[at];
                best_i = i;
                best_tbl = at;
            }
        }
        if (best_i < 0) break;
        /* merge every non-overlapping occurrence of that pair (GPT-2 BPE
         * merges all occurrences of the chosen pair in one pass) */
        int32_t a = syms[best_i], b = syms[best_i + 1];
        int32_t w = 0;
        for (int32_t r = 0; r < n; ) {
            if (r + 1 < n && syms[r] == a && syms[r + 1] == b) {
                syms[w++] = merged[best_tbl];
                r += 2;
            } else {
                syms[w++] = syms[r++];
            }
        }
        n = w;
    }
    *n_inout = n;
    return 0;
}

/* Batch variant: words concatenated in `syms`, offsets[n_words+1] delimiting
 * each word. Output lengths written to out_lens; symbols compacted in place
 * per word (caller re-reads via offsets + out_lens). */
int bpe_encode_batch(
    int32_t *syms, const int64_t *offsets, int32_t *out_lens, int64_t n_words,
    const uint64_t *keys, const int32_t *ranks, const int32_t *merged,
    int64_t n_table)
{
    for (int64_t wi = 0; wi < n_words; wi++) {
        int32_t n = (int32_t)(offsets[wi + 1] - offsets[wi]);
        bpe_encode_word(syms + offsets[wi], &n, keys, ranks, merged, n_table);
        out_lens[wi] = n;
    }
    return 0;
}
