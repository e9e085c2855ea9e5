// Batched moment-retrieval detection AP (native half of eval/metrics.py).
//
// Computes, per query, the greedy one-to-one VOC-interpolated AP of ranked
// predicted windows vs the GT window set at a vector of IoU thresholds —
// the inner loop of compute_mr_ap (reference semantics:
// standalone_eval/utils.py:83-166). The Python implementation is the
// bit-for-bit contract holder (golden-pinned); this kernel reproduces it
// EXACTLY, including:
//   * stable descending sort of prediction scores
//     (np.argsort(-scores, kind="stable"));
//   * GT visit order = np.argsort(iou_row)[::-1]: numpy's introsort runs
//     plain stable insertion sort for n <= 15, so for G <= 15 the reversed
//     order is "descending IoU, ties by larger GT index first". Queries
//     with G == 0 (NaN recall semantics) or G > 15 (introsort tie order
//     no longer insertion-stable) are left to the Python fallback;
//   * numpy's pairwise summation for the VOC integral (np.sum): sequential
//     for n < 8, the 8-accumulator scheme for 8 <= n <= 128 (queries whose
//     interpolation grid exceeds 128 terms fall back).
//
// Exact float64 arithmetic in the same operation order as the numpy code.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// np.sum replica (pairwise_sum_DOUBLE) for n <= 128.
double np_sum_small(const double* a, long n) {
    if (n < 8) {
        double res = 0.0;
        for (long i = 0; i < n; i++) res += a[i];
        return res;
    }
    double r[8];
    for (int j = 0; j < 8; j++) r[j] = a[j];
    long i = 8;
    for (; i < n - (n % 8); i += 8)
        for (int j = 0; j < 8; j++) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; i++) res += a[i];
    return res;
}

// full np.sum replica: pairwise recursion, halves rounded down to x8.
double np_sum(const double* a, long n) {
    if (n <= 128) return np_sum_small(a, n);
    long n2 = n / 2;
    n2 -= n2 % 8;
    return np_sum(a, n2) + np_sum(a + n2, n - n2);
}

// VOC-2011 interpolated AP (metrics.py _voc_interp_ap): precision/recall of
// length n, sentinel-padded, right-running max, integrate where recall moves.
double voc_interp_ap(const double* precision, const double* recall, long n) {
    std::vector<double> mprec(n + 2), mrec(n + 2);
    mprec[0] = 0.0;
    mrec[0] = 0.0;
    for (long i = 0; i < n; i++) {
        mprec[i + 1] = precision[i];
        mrec[i + 1] = recall[i];
    }
    mprec[n + 1] = 0.0;
    mrec[n + 1] = 1.0;
    for (long i = n; i >= 0; i--)
        mprec[i] = std::max(mprec[i], mprec[i + 1]);
    std::vector<double> terms;
    terms.reserve(n + 1);
    for (long i = 1; i <= n + 1; i++)
        if (mrec[i] != mrec[i - 1])
            terms.push_back((mrec[i] - mrec[i - 1]) * mprec[i]);
    return np_sum_small(terms.data(), (long)terms.size());
}

}  // namespace

extern "C" {

// preds: rows [start, end, score] flattened over queries; pred_off[q] ..
// pred_off[q+1] delimit query q. gts: rows [start, end], gt_off likewise.
// out: (nq, nthds) row-major, only rows with handled[q] == 1 are written.
// Returns the number of natively handled queries.
long mr_ap_batch(const double* preds, const long* pred_off,
                 const double* gts, const long* gt_off,
                 long nq, const double* thds, long nthds,
                 double* out, unsigned char* handled) {
    long done = 0;
    std::vector<long> order, by_iou;
    std::vector<double> iou, tp, fp, precision, recall;
    std::vector<long> locked;

    for (long q = 0; q < nq; q++) {
        handled[q] = 0;
        const long p0 = pred_off[q], p1 = pred_off[q + 1];
        const long g0 = gt_off[q], g1 = gt_off[q + 1];
        const long np_ = p1 - p0, ng = g1 - g0;
        if (np_ == 0) {  // python returns zeros before any sorting
            for (long t = 0; t < nthds; t++) out[q * nthds + t] = 0.0;
            handled[q] = 1;
            done++;
            continue;
        }
        if (ng == 0 || ng > 15 || np_ > 126) continue;  // python fallback

        // stable descending score order — np.argsort(-scores, "stable"):
        // NaN scores (i.e. -NaN) sort last in ascending order, so they come
        // last here too
        order.resize(np_);
        for (long i = 0; i < np_; i++) order[i] = i;
        std::stable_sort(order.begin(), order.end(), [&](long a, long b) {
            const double sa = preds[(p0 + a) * 3 + 2];
            const double sb = preds[(p0 + b) * 3 + 2];
            if (std::isnan(sa)) return false;
            if (std::isnan(sb)) return true;
            return sa > sb;
        });

        // IoU matrix in sorted-pred order: EXACTLY iou_cross
        // (eval/metrics.py) — union = area1 + area2 - inter with a plain
        // IEEE division, so degenerate zero-length pairs yield 0/0 = NaN
        // (NOT 0). The NaN then fails every `iou < thd` test below and the
        // prediction greedily matches — the numpy/reference behavior the
        // golden files were produced with.
        iou.assign(np_ * ng, 0.0);
        for (long i = 0; i < np_; i++) {
            const double ps = preds[(p0 + order[i]) * 3 + 0];
            const double pe = preds[(p0 + order[i]) * 3 + 1];
            const double area1 = pe - ps;
            for (long g = 0; g < ng; g++) {
                const double gs = gts[(g0 + g) * 2 + 0];
                const double ge = gts[(g0 + g) * 2 + 1];
                const double area2 = ge - gs;
                const double inter =
                    std::max(0.0, std::min(pe, ge) - std::max(ps, gs));
                const double uni = (area1 + area2) - inter;
                iou[i * ng + g] = inter / uni;
            }
        }

        tp.assign(nthds * np_, 0.0);
        fp.assign(nthds * np_, 0.0);
        locked.assign(nthds * ng, -1);
        by_iou.resize(ng);
        for (long i = 0; i < np_; i++) {
            // np.argsort(iou_row)[::-1] with G<=15: stable ascending
            // insertion sort, reversed -> descending, ties larger-index-first.
            // numpy sorts NaNs to the END of the ascending order (so they
            // lead the reversed order); a raw `<` on NaNs is not a strict
            // weak ordering, hence the explicit ranking.
            for (long g = 0; g < ng; g++) by_iou[g] = g;
            std::stable_sort(by_iou.begin(), by_iou.end(), [&](long a, long b) {
                const double va = iou[i * ng + a];
                const double vb = iou[i * ng + b];
                if (std::isnan(va)) return false;
                if (std::isnan(vb)) return true;
                return va < vb;
            });
            std::reverse(by_iou.begin(), by_iou.end());
            for (long t = 0; t < nthds; t++) {
                bool assigned = false;
                for (long k = 0; k < ng; k++) {
                    const long g = by_iou[k];
                    if (iou[i * ng + g] < thds[t]) {
                        fp[t * np_ + i] = 1.0;
                        assigned = true;
                        break;
                    }
                    if (locked[t * ng + g] >= 0) continue;
                    tp[t * np_ + i] = 1.0;
                    locked[t * ng + g] = i;
                    assigned = true;
                    break;
                }
                if (!assigned) fp[t * np_ + i] = 1.0;
            }
        }

        precision.resize(np_);
        recall.resize(np_);
        for (long t = 0; t < nthds; t++) {
            double tpc = 0.0, fpc = 0.0;
            for (long i = 0; i < np_; i++) {
                tpc += tp[t * np_ + i];
                fpc += fp[t * np_ + i];
                recall[i] = tpc / (double)ng;
                precision[i] = tpc / (tpc + fpc);
            }
            out[q * nthds + t] = voc_interp_ap(precision.data(), recall.data(), np_);
        }
        handled[q] = 1;
        done++;
    }
    return done;
}

// Binary ranking AP for K label columns per query sharing one score vector
// (the HL protocol: 3 thresholds x 3 workers = 9 columns per query).
// Bit-identical to eval/metrics.py binary_ap_columns, a replica of
// sklearn's precision_recall_curve for binary labels:
//   * mergesort-stable descending score order;
//   * PR thresholds at score changes + the last element;
//   * recall cast to float32 before the diff that picks integration points;
//   * precision right-running max (interpolated AP), numpy pairwise mean.
// scores: flattened per-query score vectors, off[q]..off[q+1]; labels: K
// columns per query, flattened as (K, n_q) blocks in query order, i.e.
// labels[koff[q]*K + k*n_q + i]. out: (nq, K).
long hl_ap_batch(const double* scores, const long* off,
                 const double* labels, long nq, long K, double* out) {
    std::vector<long> order, thd_idx;
    std::vector<double> tps, prec;
    std::vector<float> rec32;
    for (long q = 0; q < nq; q++) {
        const long s0 = off[q];
        const long n = off[q + 1] - s0;
        if (n == 0) {
            for (long k = 0; k < K; k++) out[q * K + k] = 0.0;
            continue;
        }
        const double* sc = scores + s0;
        const double* lab = labels + s0 * K;  // (K, n) block
        order.resize(n);
        for (long i = 0; i < n; i++) order[i] = i;
        std::stable_sort(order.begin(), order.end(), [&](long a, long b) {
            // mergesort-stable descending; NaN sorts last (numpy semantics).
            // Plain `sc[a] > sc[b]` violates strict weak ordering under NaN.
            if (std::isnan(sc[a])) return false;
            if (std::isnan(sc[b])) return true;
            return sc[a] > sc[b];
        });
        // PR threshold positions: where the sorted score changes, plus last
        thd_idx.clear();
        for (long i = 0; i + 1 < n; i++)
            if (sc[order[i + 1]] - sc[order[i]] != 0.0) thd_idx.push_back(i);
        thd_idx.push_back(n - 1);
        const long T = (long)thd_idx.size();

        for (long k = 0; k < K; k++) {
            const double* y = lab + k * n;
            bool single = true;
            for (long i = 1; i < n && single; i++) single = (y[i] == y[0]);
            if (single) {
                out[q * K + k] = (y[0] == 0.0) ? 0.0 : 1.0;
                continue;
            }
            // tps at thresholds (cumsum of labels in sorted order)
            tps.resize(T);
            double c = 0.0;
            long t = 0;
            for (long i = 0; i < n; i++) {
                c += y[order[i]];
                while (t < T && thd_idx[t] == i) tps[t++] = c;
            }
            const double tp_last = tps[T - 1];
            // python: precision = concat(p[::-1], [1.0]);
            //         recall    = concat(r[::-1], [0.0]) -> float32
            prec.resize(T + 1);
            rec32.resize(T + 1);
            for (long j = 0; j < T; j++) {
                const double tp = tps[T - 1 - j];
                const double fp = 1 + thd_idx[T - 1 - j] - tp;
                prec[j] = tp / (tp + fp);
                rec32[j] = (float)(tp_last > 0.0 ? tp / tp_last : 0.0);
            }
            prec[T] = 1.0;
            rec32[T] = 0.0f;
            for (long j = 1; j <= T; j++)  // np.maximum.accumulate
                prec[j] = std::max(prec[j], prec[j - 1]);
            // integrate where float32 recall moves: mean precision there
            tps.clear();  // reuse as the gathered-term buffer
            for (long j = 0; j + 1 <= T; j++)
                if (rec32[j + 1] - rec32[j] != 0.0f) tps.push_back(prec[j]);
            out[q * K + k] =
                tps.empty() ? 0.0 : np_sum(tps.data(), (long)tps.size()) /
                                        (double)tps.size();
        }
    }
    return nq;
}

}  // extern "C"
