"""ntHash v1 — exact reimplementation (NumPy host path + scalar oracle).

Semantics match the reference's vendored header
(reference: subprojects/ntedit/lib/nthash.hpp) which is the single hashing
scheme used across the whole GoldPolish pipeline: Bloom filter construction
(reference: src/utils.cpp:96-123), ntEdit editing
(reference: subprojects/ntedit/ntedit.cpp:1441-1444) and Sealer/Konnector
graph probes.

Key structural fact exploited for the TPU path: the "srol" operation
(rol1 + swapbits033, reference nthash.hpp:66-97) is an *independent rotation*
of the top 31 bits and the bottom 33 bits of the 64-bit state.  Because
rotation distributes over XOR, the forward hash of window w

    f(w) = XOR_{j=0..k-1} srol^{k-1-j}( seed(s[w+j]) )

can be rewritten as

    f(w) = srol^{(w+k-1) mod 1023}( P[w+k-1] ^ P[w-1] ),
    P    = prefix-XOR of  A[i] = srol^{(-i) mod 1023}( seed(s[i]) )

(1023 = lcm(31, 33) is the period of srol).  Likewise the reverse-strand
hash r(w) = srol^{(-w) mod 1023}( Q[w+k-1] ^ Q[w-1] ) with
Q = prefix-XOR of B[i] = srol^{i mod 1023}( rcseed(s[i]) ).  This turns the
inherently sequential rolling recurrence into one parallel prefix scan plus
elementwise variable rotations — the formulation used by the JAX/TPU kernels
(see nthash_jax.py).

All functions operate on raw ASCII byte codes (uint8) so IUPAC codes,
lowercase bases and arbitrary bytes hash exactly as the reference does
(seed table is 256 entries; the reverse-complement trick is seedTab[c & 7],
reference nthash.hpp:15,116).

Frozen copy of goldpolish_tpu_torch/ops/nthash.py for the benchmark's plain
reference (NumPy and Python only; it imports nothing of the port).
"""

from __future__ import annotations

import numpy as np

# --- constants (reference: subprojects/ntedit/lib/nthash.hpp:15-63) ---------
CP_OFF = 0x07
MULTI_SHIFT = 27
MULTI_SEED = np.uint64(0x90B45D39FB6DA1FA)

SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000

MASK64 = (1 << 64) - 1
MASK33 = (1 << 33) - 1
MASK31 = (1 << 31) - 1
SROL_PERIOD = 31 * 33  # 1023


def _build_seed_tab() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint64)
    # low slots used by the &7 reverse-complement trick
    tab[1] = SEED_T
    tab[3] = SEED_G
    tab[4] = SEED_A
    tab[7] = SEED_C
    for c, s in (("A", SEED_A), ("C", SEED_C), ("G", SEED_G), ("T", SEED_T)):
        tab[ord(c)] = s
        tab[ord(c.lower())] = s
    return tab


SEED_TAB = _build_seed_tab()
# rcseed(c) == seedTab[c & 7] (reference nthash.hpp:116,144)
RC_SEED_TAB = SEED_TAB[np.arange(256) & CP_OFF]

_U1 = np.uint64(1)
_U30 = np.uint64(30)
_U32 = np.uint64(32)
_U33 = np.uint64(33)
_M31 = np.uint64(MASK31)
_M33 = np.uint64(MASK33)


# --- split-rotate primitives -------------------------------------------------
def srol(v):
    """Rotate the 31-bit high field and 33-bit low field left by 1.

    Equivalent to rol1 + swapbits033 (reference nthash.hpp:66-91).
    Works on numpy uint64 scalars or arrays.
    """
    v = np.uint64(v) if np.isscalar(v) or isinstance(v, int) else v
    hi = v >> _U33
    lo = v & _M33
    hi = ((hi << _U1) | (hi >> _U30)) & _M31
    lo = ((lo << _U1) | (lo >> _U32)) & _M33
    return (hi << _U33) | lo


def sror(v):
    """Inverse of srol: rotate both fields right by 1.

    Equivalent to ror1 + swapbits3263 (reference nthash.hpp:71-97,149-151).
    """
    v = np.uint64(v) if np.isscalar(v) or isinstance(v, int) else v
    hi = v >> _U33
    lo = v & _M33
    hi = ((hi >> _U1) | (hi << _U30)) & _M31
    lo = ((lo >> _U1) | (lo << _U32)) & _M33
    return (hi << _U33) | lo


def srol_n(v, n):
    """srol applied n times; n may be a numpy array (broadcast against v).

    Matches (rol31(lBits,n) << 33) | rol33(rBits,n)
    (reference nthash.hpp:76-85,126-129).
    """
    v = np.asarray(v, dtype=np.uint64)
    n = np.asarray(n)
    s31 = (n % 31).astype(np.uint64)
    s33 = (n % 33).astype(np.uint64)
    hi = v >> _U33
    lo = v & _M33
    hi = ((hi << s31) | (hi >> (np.uint64(31) - s31))) & _M31
    lo = ((lo << s33) | (lo >> (np.uint64(33) - s33))) & _M33
    return (hi << _U33) | lo


# --- scalar oracle (direct transliteration of the recurrences) ---------------
def ntf64_base(codes: np.ndarray, k: int) -> int:
    """Forward-strand hash of the first k-mer (reference nthash.hpp:100-108)."""
    h = np.uint64(0)
    for i in range(k):
        h = srol(h) ^ SEED_TAB[codes[i]]
    return int(h)


def ntr64_base(codes: np.ndarray, k: int) -> int:
    """Reverse-strand hash of the first k-mer (reference nthash.hpp:111-119)."""
    h = np.uint64(0)
    for i in range(k):
        h = srol(h) ^ RC_SEED_TAB[codes[k - 1 - i]]
    return int(h)


def ntc64_base(codes: np.ndarray, k: int):
    """Canonical base hash -> (fh, rh, fh+rh) (reference nthash.hpp:180-184)."""
    fh = ntf64_base(codes, k)
    rh = ntr64_base(codes, k)
    return fh, rh, (fh + rh) & MASK64


def ntf64_roll(fh: int, k: int, char_out: int, char_in: int) -> int:
    """Slide forward hash one base (reference nthash.hpp:122-131)."""
    h = srol(np.uint64(fh)) ^ SEED_TAB[char_in] ^ srol_n(SEED_TAB[char_out], k)
    return int(h)


def ntr64_roll(rh: int, k: int, char_out: int, char_in: int) -> int:
    """Slide reverse hash one base (reference nthash.hpp:143-152)."""
    h = np.uint64(rh) ^ srol_n(RC_SEED_TAB[char_in], k) ^ RC_SEED_TAB[char_out]
    return int(sror(h))


def ntc64_roll(fh: int, rh: int, k: int, char_out: int, char_in: int):
    fh = ntf64_roll(fh, k, char_out, char_in)
    rh = ntr64_roll(rh, k, char_out, char_in)
    return fh, rh, (fh + rh) & MASK64


def ntf64_changelast(fh: int, char_out: int, char_in: int) -> int:
    """Swap the last base of the window, O(1) (reference nthash.hpp:134-140)."""
    return int(np.uint64(fh) ^ SEED_TAB[char_out] ^ SEED_TAB[char_in])


def ntr64_changelast(rh: int, k: int, char_out: int, char_in: int) -> int:
    """Reference nthash.hpp:154-169 (srol, xor rotated rc-seeds, sror)."""
    h = srol(np.uint64(rh))
    h = h ^ srol_n(RC_SEED_TAB[char_out], k) ^ srol_n(RC_SEED_TAB[char_in], k)
    return int(sror(h))


def ntc64_changelast(fh: int, rh: int, k: int, char_out: int, char_in: int):
    fh = ntf64_changelast(fh, char_out, char_in)
    rh = ntr64_changelast(rh, k, char_out, char_in)
    return fh, rh, (fh + rh) & MASK64


def nte64(base_hash, k: int, i: int):
    """The i-th extra hash from a base hash (reference nthash.hpp:261-266)."""
    with np.errstate(over="ignore"):
        t = np.uint64(base_hash) * (np.uint64(i) ^ (np.uint64(k) * MULTI_SEED))
    t ^= t >> np.uint64(MULTI_SHIFT)
    return t


def multi_hashes(base_hash, k: int, m: int) -> np.ndarray:
    """m hashes from a canonical base hash (reference nthash.hpp:281-302).

    base_hash may be a scalar or an array; output appends a trailing axis m.
    """
    b = np.asarray(base_hash, dtype=np.uint64)
    out = np.empty(b.shape + (m,), dtype=np.uint64)
    out[..., 0] = b
    for i in range(1, m):
        out[..., i] = nte64(b, k, i)
    return out


# --- batched closed-form: hashes of every window -----------------------------
def forward_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Forward-strand hash of every k-window of `codes` (len n-k+1)."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    idx = np.arange(n, dtype=np.int64)
    a = srol_n(SEED_TAB[codes], (-idx) % SROL_PERIOD)
    p = np.bitwise_xor.accumulate(a)
    w = p[k - 1 :].copy()
    w[1:] ^= p[: n - k]
    wi = np.arange(n - k + 1, dtype=np.int64)
    return srol_n(w, (wi + k - 1) % SROL_PERIOD)


def reverse_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse-strand hash of every k-window of `codes`."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    idx = np.arange(n, dtype=np.int64)
    b = srol_n(RC_SEED_TAB[codes], idx % SROL_PERIOD)
    q = np.bitwise_xor.accumulate(b)
    w = q[k - 1 :].copy()
    w[1:] ^= q[: n - k]
    wi = np.arange(n - k + 1, dtype=np.int64)
    return srol_n(w, (-wi) % SROL_PERIOD)


def canonical_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical (fh+rh) hash of every k-window."""
    return forward_hashes(codes, k) + reverse_hashes(codes, k)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII bytes of a sequence as uint8 codes (identity encoding)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(bytes(seq), dtype=np.uint8)


# --- pure-Python-int scalar kernels ------------------------------------------
# The editor's dirty-zone scans call the scalar recurrences millions of times;
# numpy scalar ops cost ~30us each while plain-int arithmetic is ~0.5us.
# These mirror the functions above exactly (mod-2^64 int arithmetic).
SEED_TAB_I = [int(x) for x in SEED_TAB]
RC_SEED_TAB_I = [int(x) for x in RC_SEED_TAB]
_MULTI_SEED_I = int(MULTI_SEED)


def srol_i(v: int) -> int:
    hi = v >> 33
    lo = v & MASK33
    hi = ((hi << 1) | (hi >> 30)) & MASK31
    lo = ((lo << 1) | (lo >> 32)) & MASK33
    return (hi << 33) | lo


def sror_i(v: int) -> int:
    hi = v >> 33
    lo = v & MASK33
    hi = ((hi >> 1) | (hi << 30)) & MASK31
    lo = ((lo >> 1) | (lo << 32)) & MASK33
    return (hi << 33) | lo


def srol_n_i(v: int, n: int) -> int:
    s31 = n % 31
    s33 = n % 33
    hi = v >> 33
    lo = v & MASK33
    hi = ((hi << s31) | (hi >> (31 - s31))) & MASK31
    lo = ((lo << s33) | (lo >> (33 - s33))) & MASK33
    return (hi << 33) | lo


def ntc64_base_i(seq, start: int, k: int) -> tuple[int, int]:
    """(fh, rh) of seq[start:start+k]; seq is bytes/bytearray."""
    fh = rh = 0
    for i in range(k):
        fh = srol_i(fh) ^ SEED_TAB_I[seq[start + i]]
        rh = srol_i(rh) ^ RC_SEED_TAB_I[seq[start + k - 1 - i]]
    return fh, rh


def ntc64_roll_i(fh: int, rh: int, k: int, c_out: int, c_in: int) -> tuple[int, int]:
    fh = srol_i(fh) ^ SEED_TAB_I[c_in] ^ srol_n_i(SEED_TAB_I[c_out], k)
    rh = sror_i(rh ^ srol_n_i(RC_SEED_TAB_I[c_in], k) ^ RC_SEED_TAB_I[c_out])
    return fh, rh


def ntc64_changelast_i(fh: int, rh: int, k: int, c_out: int, c_in: int) -> tuple[int, int]:
    fh = fh ^ SEED_TAB_I[c_out] ^ SEED_TAB_I[c_in]
    rh = sror_i(
        srol_i(rh)
        ^ srol_n_i(RC_SEED_TAB_I[c_out], k)
        ^ srol_n_i(RC_SEED_TAB_I[c_in], k)
    )
    return fh, rh


def multi_hashes_i(fh: int, rh: int, k: int, m: int) -> tuple:
    """Canonical multi-hash values as a tuple of ints."""
    b = (fh + rh) & MASK64
    out = [b]
    km = (k * _MULTI_SEED_I) & MASK64
    for i in range(1, m):
        t = (b * (i ^ km)) & MASK64
        t ^= t >> MULTI_SHIFT
        out.append(t)
    return tuple(out)


def ntc64_changefirst_i(fh: int, rh: int, k: int, c_out: int, c_in: int) -> tuple[int, int]:
    """O(1) first-base swap of a k-window's (fh, rh) state — the mirror of
    ntc64_changelast_i, used by the gap-filler's predecessor expansion.

    Derivation from the window sums (see forward_hashes/reverse_hashes):
      fh = XOR_i srol^(k-1-i)(seed[x_i])  -> x_0 term has rotation k-1,
      rh = XOR_i srol^(i)(rc_seed[x_i])   -> x_0 term has rotation 0.
    """
    fh = fh ^ srol_n_i(SEED_TAB_I[c_out] ^ SEED_TAB_I[c_in], (k - 1) % SROL_PERIOD)
    rh = rh ^ RC_SEED_TAB_I[c_out] ^ RC_SEED_TAB_I[c_in]
    return fh, rh
