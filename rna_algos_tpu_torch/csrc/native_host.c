/* The port's native host runtime: the centroid traceback and the "i,j,p "
 * probability text, with a plain C interface for ctypes (no Python.h).
 *
 * Built by _native.py with the host C compiler and -ffp-contract=off: the
 * traceback re-derives each choice of the MEA fill by float32 equality,
 * and a fused multiply-add would round M + gamma * bpp - 1 once where the
 * fill and the Python traceback round it twice, so pairs would be lost.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* centroid traceback (reference src/centroid_fold.rs:66-102)          */
/* ------------------------------------------------------------------ */

/* One structure from the (N, N) fill M and BPP bpp of a record of n <= N
 * bases: the reference's candidate order, float32 equalities and stack
 * discipline.  stack holds 2N + 4 (i, j) entries.  Writes at most cap
 * pairs; returns their number, or -1 if cap was too small. */
static int32_t traceback_one(const float *M, const float *bpp, int64_t N,
                             int64_t n, float gamma, int32_t *pairs,
                             int64_t cap, int32_t *stack)
{
    int64_t sp = 0, np_ = 0;
    stack[0] = 0;
    stack[1] = (int32_t)(n - 1);
    sp = 1;
    while (sp > 0) {
        sp--;
        int64_t i = stack[2 * sp], j = stack[2 * sp + 1];
        if (j <= i)
            continue;
        float m = M[i * N + j];
        if (m == 0.0f)
            continue;
        if (m == M[(i + 1) * N + j]) {
            stack[2 * sp] = (int32_t)(i + 1);
            stack[2 * sp + 1] = (int32_t)j;
            sp++;
        } else if (m == M[i * N + (j - 1)]) {
            stack[2 * sp] = (int32_t)i;
            stack[2 * sp + 1] = (int32_t)(j - 1);
            sp++;
        } else if (bpp[i * N + j] > 0.0f &&
                   m == M[(i + 1) * N + (j - 1)] + gamma * bpp[i * N + j]
                            - 1.0f) {
            if (np_ == cap)
                return -1;
            stack[2 * sp] = (int32_t)(i + 1);
            stack[2 * sp + 1] = (int32_t)(j - 1);
            sp++;
            pairs[2 * np_] = (int32_t)i;
            pairs[2 * np_ + 1] = (int32_t)j;
            np_++;
        } else {
            for (int64_t k = i + 1; k < j; k++) {
                if (m == M[i * N + k] + M[(k + 1) * N + j]) {
                    stack[2 * sp] = (int32_t)i;
                    stack[2 * sp + 1] = (int32_t)k;
                    stack[2 * sp + 2] = (int32_t)(k + 1);
                    stack[2 * sp + 3] = (int32_t)j;
                    sp += 2;
                    break;
                }
            }
        }
    }
    return (int32_t)np_;
}

/* The structures of R records x G gammas: fills (R, G, N, N), bpps
 * (R, N, N), ns (R,), gammas (G,), all C-contiguous.  Writes the pairs of
 * (r, g) to pairs[((r * G + g) * cap + p) * 2 + {0, 1}] and their number
 * to counts[r * G + g].  Returns 0, 1 if a record's n is outside [0, N],
 * 2 if a structure has more than cap pairs, 3 if memory ran out. */
int rna_native_traceback_batch(const float *fills, const float *bpps,
                               const int32_t *ns, const float *gammas,
                               int32_t R, int32_t G, int32_t N, int32_t cap,
                               int32_t *pairs, int32_t *counts)
{
    int64_t n2 = (int64_t)N * N;
    int32_t *stack = (int32_t *)malloc(sizeof(int32_t) * 2 * (2 * (size_t)N + 4));
    if (!stack)
        return 3;
    int err = 0;
    for (int64_t r = 0; r < R && !err; r++) {
        if (ns[r] < 0 || ns[r] > N) {
            err = 1;
            break;
        }
        for (int64_t g = 0; g < G; g++) {
            int64_t rg = r * G + g;
            int32_t c = traceback_one(fills + rg * n2, bpps + r * n2, N,
                                      ns[r], gammas[g], pairs + rg * cap * 2,
                                      cap, stack);
            if (c < 0) {
                err = 2;
                break;
            }
            counts[rg] = c;
        }
    }
    free(stack);
    return err;
}

/* ------------------------------------------------------------------ */
/* shortest round-trip float32 text (numpy format_float_positional,    */
/* unique=True, trim="-"; Rust's `{}` Display)                         */
/* ------------------------------------------------------------------ */

/* Dragon4 (Steele & White, with the digit-exponent estimate of Burger &
 * Dybvig) on small unsigned big integers: every quantity is exact, so the
 * digits are those numpy's own Dragon4 prints.  A float32 needs under 200
 * bits here; BN_BLOCKS 32-bit blocks leave room. */
#define BN_BLOCKS 12

typedef struct {
    int len;                  /* blocks in use; no leading zero block */
    uint32_t b[BN_BLOCKS];    /* little-endian */
} bn;

static void bn_set(bn *x, uint64_t v)
{
    x->len = 0;
    while (v) {
        x->b[x->len++] = (uint32_t)v;
        v >>= 32;
    }
}

static void bn_mul_small(bn *x, uint32_t m)
{
    uint64_t c = 0;
    for (int i = 0; i < x->len; i++) {
        uint64_t p = (uint64_t)x->b[i] * m + c;
        x->b[i] = (uint32_t)p;
        c = p >> 32;
    }
    if (c)
        x->b[x->len++] = (uint32_t)c;
}

static void bn_mul_pow10(bn *x, int k)
{
    for (; k >= 9; k -= 9)
        bn_mul_small(x, 1000000000u);
    static const uint32_t p10[9] = {1, 10, 100, 1000, 10000, 100000,
                                    1000000, 10000000, 100000000};
    if (k)
        bn_mul_small(x, p10[k]);
}

static void bn_shl(bn *x, int s)
{
    if (x->len == 0)
        return;
    int blocks = s / 32, bits = s % 32;
    int n = x->len;
    if (bits) {
        x->b[n] = 0;
        for (int i = n; i > 0; i--)
            x->b[i] = (x->b[i] << bits) | (x->b[i - 1] >> (32 - bits));
        x->b[0] <<= bits;
        if (x->b[n])
            n++;
    }
    if (blocks) {
        memmove(x->b + blocks, x->b, sizeof(uint32_t) * (size_t)n);
        memset(x->b, 0, sizeof(uint32_t) * (size_t)blocks);
        n += blocks;
    }
    x->len = n;
}

static int bn_cmp(const bn *a, const bn *b)
{
    if (a->len != b->len)
        return a->len < b->len ? -1 : 1;
    for (int i = a->len - 1; i >= 0; i--)
        if (a->b[i] != b->b[i])
            return a->b[i] < b->b[i] ? -1 : 1;
    return 0;
}

static void bn_add(bn *r, const bn *a, const bn *b)
{
    const bn *lo = a->len < b->len ? a : b, *hi = lo == a ? b : a;
    uint64_t c = 0;
    int i = 0;
    for (; i < lo->len; i++) {
        uint64_t s = (uint64_t)hi->b[i] + lo->b[i] + c;
        r->b[i] = (uint32_t)s;
        c = s >> 32;
    }
    for (; i < hi->len; i++) {
        uint64_t s = (uint64_t)hi->b[i] + c;
        r->b[i] = (uint32_t)s;
        c = s >> 32;
    }
    r->len = hi->len;
    if (c)
        r->b[r->len++] = (uint32_t)c;
}

/* a -= q * b, given q * b <= a */
static void bn_sub_mul(bn *a, const bn *b, uint32_t q)
{
    uint64_t carry = 0, borrow = 0;
    for (int i = 0; i < a->len; i++) {
        uint64_t p = (i < b->len ? (uint64_t)b->b[i] * q : 0) + carry;
        carry = p >> 32;
        uint64_t d = (uint64_t)a->b[i] - (uint32_t)p - borrow;
        a->b[i] = (uint32_t)d;
        borrow = (d >> 32) & 1;
    }
    while (a->len > 0 && a->b[a->len - 1] == 0)
        a->len--;
}

/* num = num mod den, returning the quotient, given num < 10 den and den's
 * top block in [2^27, 2^28) (so num has no more blocks than den). */
static uint32_t bn_divmod_digit(bn *num, const bn *den)
{
    if (num->len < den->len)
        return 0;
    uint32_t q = num->b[den->len - 1] / (den->b[den->len - 1] + 1);
    if (q)
        bn_sub_mul(num, den, q);
    while (bn_cmp(num, den) >= 0) {    /* the estimate is low by at most 1 */
        bn_sub_mul(num, den, 1);
        q++;
    }
    return q;
}

/* floor(p log10(2)) for |p| <= 1,000 */
static int floor_log10_pow2(int p)
{
    return (int)(((int64_t)p * 1262611) >> 22);
}

/* The digits of v > 0 (finite) into digits; returns their number and the
 * decimal exponent of the first in *exp10. */
static int dragon4_f32(uint32_t bits, char *digits, int *exp10)
{
    uint32_t fexp = (bits >> 23) & 0xFF, frac = bits & 0x7FFFFF;
    uint32_t mant;
    int e, mbit, unequal;
    if (fexp) {
        mant = frac | (1u << 23);
        e = (int)fexp - 150;
        mbit = 23;
        unequal = fexp != 1 && frac == 0;
    } else {
        mant = frac;
        e = -149;
        mbit = 31 - __builtin_clz(mant);
        unequal = 0;
    }
    /* value = val / scale; the gap to the neighbours below and above is
     * 2 mlo / scale and 2 mhi / scale */
    bn val, scale, mlo, mhi, tmp;
    int f = unequal ? 2 : 1;
    bn_set(&val, mant);
    if (e > 0) {
        bn_shl(&val, e + f);
        bn_set(&scale, 1u << f);
        bn_set(&mlo, 1);
        bn_shl(&mlo, e);
    } else {
        bn_shl(&val, f);
        bn_set(&scale, 1);
        bn_shl(&scale, f - e);
        bn_set(&mlo, 1);
    }
    /* k is floor(log10 v) + 1, which is est or est + 1 */
    int est = floor_log10_pow2(mbit + e) + 1;
    if (est > 0) {
        bn_mul_pow10(&scale, est);
    } else if (est < 0) {
        bn_mul_pow10(&val, -est);
        bn_mul_pow10(&mlo, -est);
    }
    int k;
    if (bn_cmp(&val, &scale) >= 0) {
        k = est + 1;
    } else {
        k = est;
        bn_mul_small(&val, 10);
        bn_mul_small(&mlo, 10);
    }
    mhi = mlo;
    if (unequal)
        bn_shl(&mhi, 1);
    /* put scale's top bit at bit 27 of its top block, for the digit
     * estimate */
    int top = 31 - __builtin_clz(scale.b[scale.len - 1]);
    int shift = (32 + 27 - top) % 32;
    if (shift) {
        bn_shl(&scale, shift);
        bn_shl(&val, shift);
        bn_shl(&mlo, shift);
        bn_shl(&mhi, shift);
    }
    int even = (mant & 1) == 0;
    int nd = 0, low, high, c;
    uint32_t d;
    for (;;) {
        d = bn_divmod_digit(&val, &scale);
        bn_add(&tmp, &val, &mhi);
        c = bn_cmp(&val, &mlo);
        low = even ? c <= 0 : c < 0;
        c = bn_cmp(&tmp, &scale);
        high = even ? c >= 0 : c > 0;
        if (low || high)
            break;
        digits[nd++] = (char)('0' + d);
        bn_mul_small(&val, 10);
        bn_mul_small(&mlo, 10);
        bn_mul_small(&mhi, 10);
    }
    int down = low;
    if (low == high) {    /* both neighbours' digits round-trip: nearest */
        bn_shl(&val, 1);
        c = bn_cmp(&val, &scale);
        down = c < 0 || (c == 0 && (d & 1) == 0);
    }
    *exp10 = k - 1;
    if (down || d < 9) {
        digits[nd++] = (char)('0' + d + !down);
        return nd;
    }
    while (nd > 0 && digits[nd - 1] == '9')    /* round up a run of 9s */
        nd--;
    if (nd == 0) {
        digits[nd++] = '1';
        *exp10 += 1;
    } else {
        digits[nd - 1]++;
    }
    return nd;
}

/* The text of v into out (at least 64 bytes); returns its length. */
static int fmt_f32(float v, char *out)
{
    uint32_t bits;
    memcpy(&bits, &v, sizeof bits);
    int pos = 0;
    if (((bits >> 23) & 0xFF) == 0xFF) {
        if (bits & 0x7FFFFF) {
            memcpy(out, "nan", 3);
            return 3;
        }
        if (bits >> 31)
            out[pos++] = '-';
        memcpy(out + pos, "inf", 3);
        return pos + 3;
    }
    if (bits >> 31)
        out[pos++] = '-';
    if ((bits & 0x7FFFFFFF) == 0) {
        out[pos++] = '0';
        return pos;
    }
    char digits[16];
    int e10;
    int nd = dragon4_f32(bits & 0x7FFFFFFF, digits, &e10);
    if (e10 >= 0) {
        int whole = e10 + 1;
        for (int i = 0; i < whole; i++)
            out[pos++] = i < nd ? digits[i] : '0';
        if (nd > whole) {
            out[pos++] = '.';
            memcpy(out + pos, digits + whole, (size_t)(nd - whole));
            pos += nd - whole;
        }
    } else {
        out[pos++] = '0';
        out[pos++] = '.';
        for (int i = 0; i < -e10 - 1; i++)
            out[pos++] = '0';
        memcpy(out + pos, digits, (size_t)nd);
        pos += nd;
    }
    return pos;
}

static int fmt_i32(int32_t v, char *out)
{
    char tmp[12];
    int n = 0, pos = 0;
    int64_t x = v;
    if (x < 0) {
        out[pos++] = '-';
        x = -x;
    }
    do {
        tmp[n++] = (char)('0' + x % 10);
        x /= 10;
    } while (x);
    while (n)
        out[pos++] = tmp[--n];
    return pos;
}

/* "i,j,p " for each of count triples into out; returns the bytes written,
 * or -1 if cap could be too small (RNA_NATIVE_TRIPLE_BYTES a triple is
 * always enough). */
#define RNA_NATIVE_TRIPLE_BYTES 96

int64_t rna_native_triple_bytes(void) { return RNA_NATIVE_TRIPLE_BYTES; }

int64_t rna_native_probs2str(const int32_t *iv, const int32_t *jv,
                             const float *pv, int64_t count, char *out,
                             int64_t cap)
{
    if (count < 0 || cap < count * RNA_NATIVE_TRIPLE_BYTES)
        return -1;
    int64_t pos = 0;
    for (int64_t t = 0; t < count; t++) {
        pos += fmt_i32(iv[t], out + pos);
        out[pos++] = ',';
        pos += fmt_i32(jv[t], out + pos);
        out[pos++] = ',';
        pos += fmt_f32(pv[t], out + pos);
        out[pos++] = ' ';
    }
    return pos;
}
