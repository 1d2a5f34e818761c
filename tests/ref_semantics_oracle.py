"""Float64 numpy oracle of the reference SPA's inf/NaN semantics.

Replays the exact arithmetic of reference src/bpa.py:27-75 +
src/math_utils.py arctanh, batched over words: total tanh-product per
check divided by the self factor, arctanh(+-1) -> +-inf, the variable
update ``v2c = marginal - c2v`` computed BEFORE ``marginal[isnan] = 0``
so inf-inf NaNs persist in the messages and virally poison check rows,
while NaN marginals decide bit 0. These dynamics are load-bearing for
the reference's committed SPA golden curves (codeword=0 runs): the
cascade progressively zeroes stuck words, suppressing the error floor
up to ~15x vs a clean saturating decoder. Used as the element-level
oracle for BPDecoder(inf_policy="reference").
"""

import numpy as np
import scipy.sparse as sp


def _arctanh_safe(tan):
    # reference math_utils.py:56-60: |val| == 1 -> signed inf, NaN stays.
    out = np.empty_like(tan)
    ind = np.abs(tan) == 1
    out[ind] = np.inf * tan[ind]
    out[~ind] = np.arctanh(tan[~ind])
    return out


def decode_spa_ref(parity_mtx, llr, max_iter):
    """Reference-semantics SPA: llr [B, V] float64 -> x_hat [B, V] int."""
    H = np.asarray(parity_mtx)
    chk_of_e, var_of_e = np.where(H)
    E = len(chk_of_e)
    C, V = H.shape
    inc_c = sp.csr_matrix((np.ones(E), (chk_of_e, np.arange(E))),
                          shape=(C, E))
    inc_v = sp.csr_matrix((np.ones(E), (var_of_e, np.arange(E))),
                          shape=(V, E))

    llr = np.asarray(llr, np.float64)
    v2c = llr[:, var_of_e].copy()
    x_hat = (llr < 0).astype(np.int64)
    done = ((x_hat @ H.T) % 2 == 0).all(axis=1)
    with np.errstate(all="ignore"):
        for _ in range(max_iter):
            if done.all():
                break
            act = ~done
            tanned = np.tanh(v2c[act] / 2.0)
            s_c = np.log(np.abs(tanned)) @ inc_c.T          # [b, C]
            neg_c = ((tanned < 0) @ inc_c.T) % 2
            prod = (1 - 2 * neg_c) * np.exp(s_c)
            c2v = 2.0 * _arctanh_safe(prod[:, chk_of_e] / tanned)
            marg = llr[act] + c2v @ inc_v.T                  # [b, V]
            v2c_new = marg[:, var_of_e] - c2v                # BEFORE zeroing
            marg[np.isnan(marg)] = 0.0
            v2c[act] = v2c_new
            xa = (marg < 0).astype(np.int64)
            x_hat[act] = xa
            idx = np.where(act)[0]
            done[idx[((xa @ H.T) % 2 == 0).all(axis=1)]] = True
    return x_hat


def decode_msa_ref(parity_mtx, llr, max_iter, check_init=True):
    """Min-sum in float64 (reference src/bpa.py:27-62 + 86-102), batched
    over words: each check sends sign-parity times the leave-one-out
    minimum magnitude, ``v2c = marginal - c2v``, decisions from the
    marginal's sign, syndrome checked before every iteration.
    ``check_init=False`` skips the iteration-0 exit, as the biAWGN
    decoders do (the reference starts from the real-valued y). Returns
    (x_hat [B, V] int, iters [B] int)."""
    H = np.asarray(parity_mtx)
    chk_of_e, var_of_e = np.where(H)
    E = len(chk_of_e)
    C, V = H.shape
    inc_v = sp.csr_matrix((np.ones(E), (var_of_e, np.arange(E))),
                          shape=(V, E))
    # Check rows as padded edge-index lists, for the leave-one-out min.
    dc = int(H.sum(axis=1).max())
    rows = np.full((C, dc), -1)
    for c in range(C):
        e = np.nonzero(chk_of_e == c)[0]
        rows[c, :e.size] = e
    pad = rows < 0

    llr = np.asarray(llr, np.float64)
    B = llr.shape[0]
    v2c = llr[:, var_of_e].copy()
    x_hat = (llr < 0).astype(np.int64)
    iters = np.zeros(B, np.int64)
    done = (((x_hat @ H.T) % 2 == 0).all(axis=1) if check_init
            else np.zeros(B, bool))
    for _ in range(max_iter):
        if done.all():
            break
        act = ~done
        m = v2c[act][:, np.where(pad, 0, rows)]             # [b, C, dc]
        mag = np.where(pad, np.inf, np.abs(m))
        neg = np.where(pad, 0, m < 0).sum(axis=-1) % 2       # [b, C]
        order = np.argsort(mag, axis=-1, kind="stable")
        min1 = np.take_along_axis(mag, order[..., :1], -1)
        min2 = np.take_along_axis(mag, order[..., 1:2], -1)
        slot = np.arange(dc)
        ext = np.where(slot == order[..., :1], min2, min1)
        sgn = np.where((neg[..., None] + (m < 0)) % 2 == 1, -1.0, 1.0)
        c2v = np.zeros((int(act.sum()), E))
        c2v[:, rows[~pad]] = (sgn * ext)[:, ~pad]
        marg = llr[act] + c2v @ inc_v.T                      # [b, V]
        v2c[act] = marg[:, var_of_e] - c2v
        xa = (marg < 0).astype(np.int64)
        x_hat[act] = xa
        iters[act] += 1
        idx = np.where(act)[0]
        done[idx[((xa @ H.T) % 2 == 0).all(axis=1)]] = True
    return x_hat, iters


def decode_bec_ref(parity_mtx, y, max_iter):
    """Reference-semantics ternary BEC SPA (src/bec.py:70-122), one word:
    echo / single-unknown parity resolve / stopping-set exit. Used to
    prove BECSPADecoder word-exactness (see test_bec_spa_oracle)."""
    H = np.asarray(parity_mtx)
    xx, yy = np.where(H)
    E = len(xx)
    C, V = H.shape
    inc_c = sp.csr_matrix((np.ones(E), (xx, np.arange(E))), shape=(C, E))
    inc_v = sp.csr_matrix((np.ones(E), (yy, np.arange(E))), shape=(V, E))
    msg = np.array([-1.0, 1.0, 0.0])
    sym = np.array([0, 2, 1])          # sign {-1,0,1} + 1 -> {0,2,1}

    priors = msg[y]
    v2c = priors[yy].copy()
    c2v = np.zeros(E)
    x_hat = np.asarray(y).copy()
    for it in range(max_iter):
        if (x_hat == 2).sum() == 0:
            return x_hat
        unknowns = (1 - np.abs(v2c)) @ inc_c.T
        ma_0 = (unknowns == 0)[xx]
        ma_1 = (unknowns == 1)[xx]
        c2v[ma_0] = v2c[ma_0]
        c2v[(unknowns > 1)[xx]] = 0.0
        erased_pos = np.abs(v2c[ma_1])
        incoming = ((v2c > 0) @ inc_c.T)[xx][ma_1]
        c2v[ma_1] = (1 - erased_pos) * (2 * (incoming % 2) - 1)
        marginal = priors + c2v @ inc_v.T
        v2c = np.sign(marginal[yy] - c2v)
        x_new = sym[np.sign(marginal).astype(int) + 1]
        if (x_hat == x_new).all():
            return x_new                # stopping set
        x_hat = x_new
    return x_hat
