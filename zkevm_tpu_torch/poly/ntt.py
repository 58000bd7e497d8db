"""Radix-2 NTT / iNTT over BN254 Fr (kernel B) and the four-step NTT
(kernel I), each with its plain version.

Port of ``zkevm_tpu/poly/ntt.py`` (``_fft_core``, ``ntt``, ``intt``,
``scale_by_powers``, ``coset_ntt``, ``coset_intt``, and the four-step
``ntt_t``, ``intt_t``). Arrays have shape ``(..., n, 8)``: leading
dimensions batch several polynomials through one transform (where the
reference bench vmaps ``ntt_t``). On CUDA the radix-2 transform is the
kernel in ``csrc/ntt.cu`` (one pass up to 2^12 elements, a column and a
row pass up to 2^24, one more column pass up to 2^36, with the coset shift
and the inverse's 1/n fused into its loads and stores) and the four-step
one the three passes of ``csrc/ntt4.cu`` (column pass, row pass,
transpose); on the CPU the plain versions below repeat the reference's
stage loop with the field's plain arithmetic, and scale by the powers
apart. Twiddle and power tables are
built on the tensor's device by a prefix product (kernel A), the twiddle
tables cached per size.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD, fr_root_of_unity

ONE_PASS_LOG = 12  # kernel B's sub-transforms hold 2^12 elements: 1, 2, 3 passes up to 2^12, 2^24, 2^36
SCRATCH_ELEMS = 1 << 25  # kernel B's scratch between its passes: at most 2^25 elements (1 GiB)
FOURSTEP_MIN_K = 8  # ntt_t: one radix-2 transform at k <= 7, four steps above
SUB_LOG_MAX = 12  # kernel I holds one sub-transform of up to 2^12 elements in shared memory


POWER_SPLIT = 12  # power tables above 2^12 entries: two small ones and one product an entry


def power_table(base: int, n: int, device) -> torch.Tensor:
    """(n, 8) Montgomery powers base^i, i < n, built on ``device``: a prefix
    product up to 2^12 entries; above, base^(i - i mod 2^12) times
    base^(i mod 2^12), one Montgomery product an entry (the same values)."""
    b = FR.const(base, device)
    lo_n = 1 << POWER_SPLIT
    if n <= lo_n:
        return ff.prefix_product(FR, b.expand(n, ff.W))
    lo = power_table(base, lo_n, device)
    hi = power_table(pow(base, lo_n, FR_MOD), -(-n // lo_n), device)
    return ff.mont_mul(FR, hi[:, None], lo[None]).reshape(-1, ff.W)[:n]


@lru_cache(maxsize=32)
def _omega_powers(k: int, inverse: bool, device: str) -> torch.Tensor:
    omega = fr_root_of_unity(k)
    if inverse:
        omega = pow(omega, FR_MOD - 2, FR_MOD)
    return power_table(omega, max((1 << k) // 2, 1), device)


@lru_cache(maxsize=32)
def _bitrev_perm(k: int, device: str) -> torch.Tensor:
    idx = torch.arange(1 << k, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev.to(device)


def _plain_fft(a: torch.Tensor, k: int, tw: torch.Tensor) -> torch.Tensor:
    n = 1 << k
    batch = a.shape[:-2]
    a = a.index_select(-2, _bitrev_perm(k, str(a.device)))
    for s in range(1, k + 1):
        m = 1 << s
        half = m // 2
        w = tw[:: n // m][:half]
        x = a.reshape(*batch, n // m, 2, half, ff.W)
        even = x[..., 0, :, :]
        odd = ff.PLAIN["mul"](FR, x[..., 1, :, :], w)
        a = torch.cat([ff.PLAIN["add"](FR, even, odd), ff.PLAIN["sub"](FR, even, odd)], dim=-2)
        a = a.reshape(*batch, n, ff.W)
    return a


def fft_passes(k: int, sub: int = ONE_PASS_LOG) -> list[tuple]:
    """Kernel B's launches for a 2^k transform whose sub-transforms hold up to
    2^sub elements, in order, one pass through device memory each:
    ``("cols", dst, src, m, k1, 0)``, the column pass of 2^m-element
    transforms viewed as 2^k1 rows, or ``("rows", dst, src, k2, log_n1,
    log_outer)``, the row pass (``csrc/ntt.cu``), with dst and src each one
    of "in", "out" and "scratch". One row pass up to 2^sub elements; a
    column and a row pass (the four-step split) up to 2^(2 sub); above, up
    to 2^(3 sub), a column pass of 2^(k // 3) rows into the output and the
    two passes over every row it leaves."""
    if k <= sub:
        return [("rows", "out", "in", k, 0, 0)]
    if k <= 2 * sub:
        k1, k2 = fourstep_split(k)
        return [("cols", "scratch", "in", k, k1, 0), ("rows", "out", "scratch", k2, k1, 0)]
    if k <= 3 * sub:
        k0 = k // 3
        k1, k2 = fourstep_split(k - k0)
        return [("cols", "out", "in", k, k0, 0), ("cols", "scratch", "out", k - k0, k1, 0),
                ("rows", "out", "scratch", k2, k1, k0)]
    raise ValueError(f"ntt: k={k} above {3 * sub}, the sizes kernel B's three passes hold")


def _launch_fft(a: torch.Tensor, k: int, inverse: bool, pre, post, scale) -> torch.Tensor:
    """Kernel B on (..., 2^k, 8): the launches of :func:`fft_passes`, over
    groups of columns that the scratch buffer holds. ``pre`` / ``post``
    (2^k, 8) tables or None, ``scale`` one element or None; ``pre`` goes to
    the first pass, ``post`` and ``scale`` to the last."""
    kernels.check_cuda_tensor("ntt input", a, torch.int32, ff.W)
    n = 1 << k
    for name, t, shape in (("pre", pre, (n, ff.W)), ("post", post, (n, ff.W)), ("scale", scale, (ff.W,))):
        if t is not None:
            kernels.check_cuda_tensor(f"ntt {name}", t, torch.int32, ff.W)
            if tuple(t.shape) != shape:
                raise ValueError(f"ntt {name}: expected shape {shape}, got {tuple(t.shape)}")
    passes = fft_passes(k)
    batch = a.numel() // (n * ff.W)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    dev = str(a.device)
    group = batch if len(passes) == 1 else max(1, SCRATCH_ELEMS >> k)
    scratch = None
    if len(passes) > 1:
        scratch = torch.empty(min(group, batch), n, ff.W, dtype=torch.int32, device=a.device)
    step = n * ff.W * 4  # bytes of one column
    for c0 in range(0, batch, group):
        cols = min(group, batch - c0)
        buf = {"in": a.data_ptr() + c0 * step, "out": out.data_ptr() + c0 * step, "scratch": ptr(scratch)}
        for i, (kind, dst, src, m, sub, outer) in enumerate(passes):
            first = ptr(pre) if i == 0 else 0
            last = i == len(passes) - 1
            if kind == "cols":
                kernels.launch("ntt", "ntt", "zk_ntt_cols", buf[dst], buf[src],
                               _omega_powers(m, inverse, dev).data_ptr(),
                               _omega_powers(sub, inverse, dev).data_ptr(), first, m, sub, cols << (k - m))
            else:
                kernels.launch("ntt", "ntt", "zk_ntt_rows", buf[dst], buf[src],
                               _omega_powers(m, inverse, dev).data_ptr(), first, ptr(post) if last else 0,
                               ptr(scale) if last else 0, m, sub, outer, cols << (k - m))
    return out


def fft_core(a: torch.Tensor, k: int, inverse: bool, pre: torch.Tensor | None = None,
             post: torch.Tensor | None = None, scale: torch.Tensor | None = None) -> torch.Tensor:
    """In-order -> in-order radix-2 DIT NTT over dim -2 of (..., n, 8), each
    input element j times ``pre[j]`` and each output element i times
    ``post[i]`` (or ``scale``), where given."""
    n = 1 << k
    if a.shape[-2] != n:
        raise ValueError(f"ntt: expected {n} rows, got shape {tuple(a.shape)}")
    if n == 1:
        out = a.clone()
        for t in (pre, post if post is not None else scale):
            if t is not None:
                out = ff.mont_mul(FR, out, t)
        return out
    if a.device.type == "cpu":
        tw = _omega_powers(k, inverse, str(a.device))
        x = _plain_fft(a if pre is None else ff.PLAIN["mul"](FR, a, pre), k, tw)
        post = post if post is not None else scale
        return x if post is None else ff.PLAIN["mul"](FR, x, post)
    return _launch_fft(a.contiguous(), k, inverse, pre, post, scale)


def _log2(a: torch.Tensor) -> int:
    return int(a.shape[-2]).bit_length() - 1


def ntt(a: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Coefficients -> evaluations on the 2^k domain (natural order)."""
    return fft_core(a, _log2(a) if k is None else k, inverse=False)


def intt(a: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Evaluations -> coefficients (includes the 1/n scaling, fused into
    the transform's stores on CUDA)."""
    k = _log2(a) if k is None else k
    return fft_core(a, k, inverse=True, scale=_n_inv(k, a.device))


def scale_by_powers(a: torch.Tensor, base: int) -> torch.Tensor:
    """a[..., i, :] *= base^i -- the coset-shift step of a coset FFT."""
    return ff.mont_mul(FR, a, power_table(base, a.shape[-2], a.device))


def coset_ntt(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluate the polynomial on the coset shift * <omega>: the transform
    of a[i] shift^i (the powers applied as kernel B loads a)."""
    return fft_core(a, _log2(a), inverse=False, pre=power_table(shift, a.shape[-2], a.device))


def coset_intt(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Inverse of :func:`coset_ntt`: output i times shift^-i / n, one
    product as kernel B stores it."""
    k = _log2(a)
    post = ff.mont_mul(FR, power_table(pow(shift, FR_MOD - 2, FR_MOD), 1 << k, a.device), _n_inv(k, a.device))
    return fft_core(a, k, inverse=True, post=post)


# ---------------------------------------------------------------------------
# Four-step NTT (kernel I and its plain version)
# ---------------------------------------------------------------------------

def fourstep_split(k: int) -> tuple[int, int]:
    """(k1, k2): the (2^k1, 2^k2) matrix view of a 2^k transform."""
    return k // 2, k - k // 2


def _n_inv(k: int, device) -> torch.Tensor:
    return FR.const(pow(1 << k, FR_MOD - 2, FR_MOD), device)


def _sub_table(tw: torch.Tensor, k: int, sub: int) -> torch.Tensor:
    """Powers of the 2^sub-th root from the table of the 2^k-th one."""
    return tw[:: 1 << (k - sub)]


def _plain_cols(a: torch.Tensor, k: int, c0: int = 0, inverse: bool = False) -> torch.Tensor:
    tw = _omega_powers(k, inverse, str(a.device))
    batch, n1, ncols, _ = a.shape
    k1 = n1.bit_length() - 1
    x = a.movedim(-3, -2)  # (batch, ncols, n1, 8): the columns along dim -2
    if k1:
        x = _plain_fft(x, k1, _sub_table(tw, k, k1))
    x = x.movedim(-2, -3)
    e = torch.arange(n1)[:, None] * torch.arange(c0, c0 + ncols)[None, :]  # < 2^k
    half = max((1 << k) // 2, 1)
    low = tw[(e % half).reshape(-1).to(tw.device)].reshape(n1, ncols, ff.W)
    powers = torch.where((e >= half)[..., None].to(tw.device),
                         ff.PLAIN["sub"](FR, torch.zeros_like(low), low), low)  # w^(n/2) = -1
    return ff.PLAIN["mul"](FR, x, powers)


def _launch_cols(a: torch.Tensor, k: int, c0: int, tw: torch.Tensor) -> torch.Tensor:
    batch, n1, ncols, _ = a.shape
    ld = a.stride(1) // ff.W
    if (a.dtype != torch.int32 or a.stride(3) != 1 or a.stride(2) != ff.W or a.stride(1) % ff.W
            or (batch > 1 and a.stride(0) != n1 * a.stride(1)) or a.data_ptr() % 16):
        raise ValueError(f"ntt4 column pass: expected int32 rows of 8-word elements, strides {a.stride()}")
    out = torch.empty(batch, n1, ncols, ff.W, dtype=torch.int32, device=a.device)
    kernels.launch("ntt4", "ntt4", "zk_ntt4_cols", out.data_ptr(), a.data_ptr(), tw.data_ptr(), k,
                   n1.bit_length() - 1, ld, ncols, c0, batch)
    return out


def ntt4_cols(a: torch.Tensor, k: int, c0: int = 0, inverse: bool = False) -> torch.Tensor:
    """Column pass of a 2^k four-step transform: a (batch, n1, ncols, 8)
    (a view of columns c0 .. c0 + ncols of (n1, n2) matrices) -> the size-n1
    transform of every column, output row r times w^(r * (c0 + c)); a new
    (batch, n1, ncols, 8) tensor."""
    k1 = a.shape[1].bit_length() - 1 if a.dim() == 4 else -1
    if (k1 < 0 or a.shape[3] != ff.W or 1 << k1 != a.shape[1] or k1 > min(k, SUB_LOG_MAX)
            or c0 < 0 or c0 + a.shape[2] > (1 << k) >> k1):
        raise ValueError(f"ntt4 column pass: bad shape {tuple(a.shape)} for k={k}, c0={c0}")
    if a.device.type == "cpu":
        return _plain_cols(a, k, c0, inverse)
    return _launch_cols(a, k, c0, _omega_powers(k, inverse, str(a.device)))


def _row_view(a: torch.Tensor, rows: int, n2: int, parts: int) -> torch.Tensor:
    """The rows of a buffer of ``parts`` blocks of (rows, n2 / parts)."""
    return a.reshape(parts, rows, n2 // parts, ff.W).transpose(0, 1).reshape(rows, n2, ff.W)


def _plain_rows(a: torch.Tensor, k: int, k2: int, parts: int = 1, inverse: bool = False) -> torch.Tensor:
    n2 = 1 << k2
    tw = _omega_powers(k, inverse, str(a.device))
    x = _plain_fft(_row_view(a, a.numel() // (ff.W * n2), n2, parts), k2, _sub_table(tw, k, k2))
    return ff.PLAIN["mul"](FR, x, _n_inv(k, a.device)) if inverse else x


def _launch_rows(a: torch.Tensor, k: int, k2: int, parts: int, tw: torch.Tensor, scale) -> torch.Tensor:
    kernels.check_cuda_tensor("ntt4 row pass input", a, torch.int32, ff.W)
    rows = a.numel() // (ff.W << k2)
    out = torch.empty(rows, 1 << k2, ff.W, dtype=torch.int32, device=a.device)
    kernels.launch("ntt4", "ntt4", "zk_ntt4_rows", out.data_ptr(), a.data_ptr(), tw.data_ptr(),
                   0 if scale is None else scale.data_ptr(), k, k2, rows, parts)
    return out


def ntt4_rows(a: torch.Tensor, k: int, k2: int, parts: int = 1, inverse: bool = False) -> torch.Tensor:
    """Row pass of a 2^k four-step transform (k2 = k for the one-pass
    transform of k <= 7): ``a`` holds rows of n2 = 2^k2 elements, given as
    ``parts`` blocks of (rows, n2 / parts), one after another (contiguous
    rows when parts = 1) -> (rows, n2, 8), the size-n2 transform of every
    row, times 1/2^k for an inverse."""
    n2 = 1 << k2
    if (a.shape[-1] != ff.W or a.numel() % (ff.W * n2) or not 1 <= k2 <= min(k, SUB_LOG_MAX)
            or parts < 1 or parts & (parts - 1) or n2 % parts):
        raise ValueError(f"ntt4 row pass: bad shape {tuple(a.shape)} for k={k}, k2={k2}, parts={parts}")
    if a.device.type == "cpu":
        return _plain_rows(a, k, k2, parts, inverse)
    tw = _omega_powers(k, inverse, str(a.device))
    return _launch_rows(a.contiguous(), k, k2, parts, tw, _n_inv(k, a.device) if inverse else None)


def _plain_transpose(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(1, 2).contiguous()


def ntt4_transpose(a: torch.Tensor) -> torch.Tensor:
    """(batch, R, S, 8) -> (batch, S, R, 8), the last step of the four-step
    transform."""
    if a.dim() != 4 or a.shape[3] != ff.W:
        raise ValueError(f"ntt4 transpose: expected (batch, R, S, 8), got {tuple(a.shape)}")
    if a.device.type == "cpu":
        return _plain_transpose(a)
    a = a.contiguous()
    kernels.check_cuda_tensor("ntt4 transpose input", a, torch.int32, ff.W)
    batch, r, s, _ = a.shape
    out = torch.empty(batch, s, r, ff.W, dtype=torch.int32, device=a.device)
    kernels.launch("ntt4", "ntt4", "zk_ntt4_transpose", out.data_ptr(), a.data_ptr(), r, s, batch)
    return out


def _fourstep(a: torch.Tensor, k: int, inverse: bool, cols, rows, transpose) -> torch.Tensor:
    if not 0 <= k <= 2 * SUB_LOG_MAX:
        raise ValueError(f"ntt_t: k={k} outside [0, {2 * SUB_LOG_MAX}], the sizes the sub-transforms hold")
    n = 1 << k
    if a.shape[-2] != n or a.shape[-1] != ff.W:
        raise ValueError(f"ntt_t: expected (..., {n}, 8), got {tuple(a.shape)}")
    lead = a.shape[:-2]
    x = a.reshape(-1, n, ff.W)
    if n == 1:
        return a.clone()
    if k < FOURSTEP_MIN_K:
        out = rows(x, k, k, inverse=inverse)
    else:
        k1, k2 = fourstep_split(k)
        b = cols(x.reshape(-1, 1 << k1, 1 << k2, ff.W), k, inverse=inverse)
        b = rows(b, k, k2, inverse=inverse)
        out = transpose(b.reshape(-1, 1 << k1, 1 << k2, ff.W))
    return out.reshape(*lead, n, ff.W)


def ntt_t(a: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """The four-step NTT of (..., 2^k, 8) Montgomery words, natural order in
    and out (the reference's limbs-first ``ntt_t`` on the port's layout): one
    transform at k <= 7; above, the (2^(k//2), 2^(k - k//2)) view's column
    pass with its twiddle, row pass and transpose. The inverse scales by
    1/2^k."""
    return _fourstep(a, k, inverse, ntt4_cols, ntt4_rows, ntt4_transpose)


def intt_t(a: torch.Tensor, k: int) -> torch.Tensor:
    return ntt_t(a, k, inverse=True)


def _plain_ntt_t(a: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """ntt_t through the plain version of every pass, on any device."""
    return _fourstep(a, k, inverse, _plain_cols, _plain_rows, _plain_transpose)


PLAIN = {"fft": _plain_fft, "ntt4_cols": _plain_cols, "ntt4_rows": _plain_rows,
         "ntt4_transpose": _plain_transpose, "ntt_t": _plain_ntt_t}
