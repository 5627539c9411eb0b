// JPEG 2000 tier 1 for the port's host codec: one code-block's MQ-coded
// (or BYPASS raw) bit-planes back to its coefficients at twice their scale,
// as OpenJPEG 2.5 decodes them. The native twin of
// optixpathtracer_tpu_torch/io/codecs/j2k_t1.py:decode_cblk_py, which is the
// reference: same passes, same scan order, same contexts, bit for bit.
//
// Built at first use with `g++ -O2 -shared -fPIC` by utils/host_build.py.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                          17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                          33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                          15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                          30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
const int CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18;
const int LAZY = 1, RESET = 2, VSC = 8, SEGSYM = 32;
const int SC_CTX[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
const int SC_XOR[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

struct MQ {
    const uint8_t *buf;  // the segment, then 0xFF 0xFF
    uint32_t bp, a, c, ct;

    void bytein() {
        if (buf[bp] == 0xFF) {
            if (buf[bp + 1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                bp++;
                c += (uint32_t)buf[bp] << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += (uint32_t)buf[bp] << 8;
            ct = 8;
        }
    }
    void init_mq(const uint8_t *b, uint32_t len) {
        buf = b;
        bp = 0;
        c = (uint32_t)(len == 0 ? 0xFF : b[0]) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void init_raw(const uint8_t *b) {
        buf = b;
        bp = 0;
        c = 0;
        ct = 0;
    }
    int decode(uint8_t *ctx, int cx) {
        int st = ctx[cx], s = st >> 1, mps = st & 1, d;
        uint32_t q = QE[s];
        a -= q;
        if ((c >> 16) < q) {
            if (a < q) {
                d = mps;
                ctx[cx] = (uint8_t)(NMPS[s] << 1 | mps);
            } else {
                d = 1 - mps;
                ctx[cx] = (uint8_t)(NLPS[s] << 1 | (mps ^ SWITCH[s]));
            }
            a = q;
        } else {
            c -= q << 16;
            if (a & 0x8000) return mps;
            if (a < q) {
                d = 1 - mps;
                ctx[cx] = (uint8_t)(NLPS[s] << 1 | (mps ^ SWITCH[s]));
            } else {
                d = mps;
                ctx[cx] = (uint8_t)(NMPS[s] << 1 | mps);
            }
        }
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
        return d;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (buf[bp] > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = buf[bp++];
                    ct = 7;
                }
            } else {
                c = buf[bp++];
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

void reset(uint8_t *ctx) {
    memset(ctx, 0, 19);
    ctx[CTX_UNI] = 46 << 1;
    ctx[CTX_AGG] = 3 << 1;
    ctx[0] = 4 << 1;
}

uint8_t ZC[4][45];

void init_zc() {
    for (int o = 0; o < 4; o++)
        for (int h = 0; h < 3; h++)
            for (int v = 0; v < 3; v++)
                for (int d = 0; d < 5; d++) {
                    int n;
                    if (o == 3) {
                        int hv = h + v;
                        if (d >= 2) n = d >= 3 ? 8 : (hv >= 1 ? 7 : 6);
                        else if (d == 1) n = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
                        else n = hv >= 2 ? 2 : hv;
                    } else {
                        int a = o == 1 ? v : h, b = o == 1 ? h : v;
                        if (a == 0) n = b == 0 ? (d == 0 ? 0 : (d == 1 ? 1 : 2)) : (b == 1 ? 3 : 4);
                        else if (a == 1) n = b == 0 ? (d == 0 ? 5 : 6) : 7;
                        else n = 8;
                    }
                    ZC[o][h * 15 + v * 5 + d] = (uint8_t)n;
                }
}

struct Block {
    int W, w, h, vsc;
    std::vector<int8_t> sig;  // 0, 1 positive, -1 negative
    std::vector<uint8_t> vis, ref;
    std::vector<int32_t> val;
    const uint8_t *zc;

    bool below(int y) const { return !(vsc && (y & 3) == 3); }
    int zc_ctx(int p, int y) const {
        int hh = (sig[p - 1] != 0) + (sig[p + 1] != 0);
        int vv = sig[p - W] != 0;
        int dd = (sig[p - W - 1] != 0) + (sig[p - W + 1] != 0);
        if (below(y)) {
            vv += sig[p + W] != 0;
            dd += (sig[p + W - 1] != 0) + (sig[p + W + 1] != 0);
        }
        return zc[hh * 15 + vv * 5 + dd];
    }
    bool any_nb(int p, int y) const {
        if (sig[p - 1] || sig[p + 1] || sig[p - W] || sig[p - W - 1] || sig[p - W + 1]) return true;
        return below(y) && (sig[p + W] || sig[p + W - 1] || sig[p + W + 1]);
    }
    int sign(MQ &mq, uint8_t *ctx, int p, int y) const {
        int hc = sig[p - 1] + sig[p + 1];
        int vc = sig[p - W] + (below(y) ? sig[p + W] : 0);
        hc = hc > 0 ? 1 : (hc < 0 ? -1 : 0);
        vc = vc > 0 ? 1 : (vc < 0 ? -1 : 0);
        int i = (hc + 1) * 3 + vc + 1;
        return mq.decode(ctx, SC_CTX[i]) ^ SC_XOR[i];
    }
    void set(int p, int s, int32_t oph) {
        val[p] = s ? -oph : oph;
        sig[p] = s ? -1 : 1;
    }
};

}  // namespace

extern "C" int j2k_t1_decode_cblk(const char *data, const int32_t *segs, int nsegs, int w, int h, int orient,
                                  int numbps, int roishift, int cblksty, int32_t *out) {
    static bool inited = false;
    if (!inited) {
        init_zc();
        inited = true;
    }
    Block b;
    b.w = w;
    b.h = h;
    b.W = w + 2;
    b.vsc = cblksty & VSC;
    size_t size = (size_t)b.W * (h + 2);
    b.sig.assign(size, 0);
    b.vis.assign(size, 0);
    b.ref.assign(size, 0);
    b.val.assign(size, 0);
    b.zc = ZC[orient & 3];
    uint8_t ctx[19];
    reset(ctx);
    int bp1 = roishift + numbps;
    if (bp1 >= 31) return -1;
    int passtype = 2;
    size_t pos = 0;
    std::vector<uint8_t> seg;
    const int W = b.W;
    for (int si = 0; si < nsegs; si++) {
        int length = segs[2 * si], npasses = segs[2 * si + 1];
        bool raw = bp1 <= numbps - 4 && passtype < 2 && (cblksty & LAZY);
        seg.assign((const uint8_t *)data + pos, (const uint8_t *)data + pos + length);
        seg.push_back(0xFF);
        seg.push_back(0xFF);
        pos += length;
        MQ mq;
        if (raw) mq.init_raw(seg.data());
        else mq.init_mq(seg.data(), (uint32_t)length);
        for (int pi = 0; pi < npasses && bp1 >= 1; pi++) {
            int32_t one = 1 << bp1, half = one >> 1, oph = one | half;
            if (passtype == 0) {
                for (int k = 0; k < h; k += 4)
                    for (int x = 0; x < w; x++)
                        for (int y = k; y < k + 4 && y < h; y++) {
                            int p = (y + 1) * W + x + 1;
                            if (b.sig[p] || b.vis[p] || !b.any_nb(p, y)) continue;
                            if (raw) {
                                if (mq.raw()) b.set(p, mq.raw(), oph);
                            } else if (mq.decode(ctx, b.zc_ctx(p, y))) {
                                b.set(p, b.sign(mq, ctx, p, y), oph);
                            }
                            b.vis[p] = 1;
                        }
            } else if (passtype == 1) {
                for (int k = 0; k < h; k += 4)
                    for (int x = 0; x < w; x++)
                        for (int y = k; y < k + 4 && y < h; y++) {
                            int p = (y + 1) * W + x + 1;
                            if (!b.sig[p] || b.vis[p]) continue;
                            int v;
                            if (raw) {
                                v = mq.raw();
                            } else {
                                int cx = b.ref[p] ? CTX_MAG + 2 : (b.any_nb(p, y) ? CTX_MAG + 1 : CTX_MAG);
                                v = mq.decode(ctx, cx);
                            }
                            b.val[p] += (v ^ (b.val[p] < 0)) ? half : -half;
                            b.ref[p] = 1;
                        }
            } else {
                for (int k = 0; k < h; k += 4) {
                    bool full = k + 4 <= h;
                    for (int x = 0; x < w; x++) {
                        int start = k;
                        if (full) {
                            bool quiet = true;
                            for (int y = k; y < k + 4 && quiet; y++) {
                                int p = (y + 1) * W + x + 1;
                                if (b.sig[p] || b.vis[p] || b.any_nb(p, y)) quiet = false;
                            }
                            if (quiet) {
                                if (!mq.decode(ctx, CTX_AGG)) continue;
                                int run = mq.decode(ctx, CTX_UNI) << 1;
                                run |= mq.decode(ctx, CTX_UNI);
                                int y = k + run;
                                int p = (y + 1) * W + x + 1;
                                b.set(p, b.sign(mq, ctx, p, y), oph);
                                start = y + 1;
                            }
                        }
                        for (int y = start; y < k + 4 && y < h; y++) {
                            int p = (y + 1) * W + x + 1;
                            if (b.sig[p] || b.vis[p]) continue;
                            if (mq.decode(ctx, b.zc_ctx(p, y))) b.set(p, b.sign(mq, ctx, p, y), oph);
                        }
                    }
                }
                std::fill(b.vis.begin(), b.vis.end(), 0);
                if (cblksty & SEGSYM)
                    for (int i = 0; i < 4; i++) mq.decode(ctx, CTX_UNI);
            }
            if ((cblksty & RESET) && !raw) reset(ctx);
            if (++passtype == 3) {
                passtype = 0;
                bp1--;
            }
        }
    }
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) out[(size_t)y * w + x] = b.val[(size_t)(y + 1) * W + x + 1];
    return 0;
}
