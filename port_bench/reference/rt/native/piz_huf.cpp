// Canonical-Huffman decoder for EXR PIZ blocks (the hot loop of
// rene_tpu_torch/scene/assets/images.py:_huf_decode, which stays as the
// pure-python fallback). Follows the documented OpenEXR ImfHuf format:
// 20-byte header (im, iM, tableLength, nBits, room), 6-bit code-length
// table with zero-run packing, MSB-first bitstream, RLE symbol == iM.
//
// C ABI + ctypes (no pybind11 in this image); compiled into
// librene_native.so next to the BVH builder.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t pos = 0;
    uint64_t c = 0;
    int lc = 0;

    bool bits(int n, uint64_t* out) {
        while (lc < n) {
            if (pos >= len) return false;
            c = (c << 8) | data[pos++];
            lc += 8;
        }
        lc -= n;
        *out = (c >> lc) & ((1ull << n) - 1);
        return true;
    }
};

constexpr int kDecBits = 14;
constexpr int kMaxLen = 58;

}  // namespace

extern "C" int rene_huf_decode(const uint8_t* data, int64_t len,
                               int64_t n_out, uint16_t* out) {
    if (len < 20) return 1;
    uint32_t im, iM, table_len, n_bits, room;
    std::memcpy(&im, data, 4);
    std::memcpy(&iM, data + 4, 4);
    std::memcpy(&table_len, data + 8, 4);
    std::memcpy(&n_bits, data + 12, 4);
    std::memcpy(&room, data + 16, 4);
    (void)table_len;
    (void)room;
    if (iM > 65536 || im > iM) return 2;  // HUF_ENCSIZE is 65537 symbols

    // code lengths (6-bit entries, zero-run packed)
    std::vector<uint8_t> lens(iM + 1, 0);
    BitReader br{data + 20, len - 20};
    for (uint32_t i = im; i <= iM;) {
        uint64_t l;
        if (!br.bits(6, &l)) return 3;
        if (l == 63) {
            uint64_t run;
            if (!br.bits(8, &run)) return 3;
            i += static_cast<uint32_t>(run) + 6;
        } else if (l >= 59) {
            i += static_cast<uint32_t>(l) - 59 + 2;
        } else {
            lens[i++] = static_cast<uint8_t>(l);
        }
    }

    // canonical codes (ImfHuf hufCanonicalCodeTable)
    int64_t cnt[kMaxLen + 1] = {0};
    for (uint32_t s = 0; s <= iM; ++s) cnt[lens[s]]++;
    int64_t first[kMaxLen + 1] = {0};
    int64_t c = 0;
    for (int l = kMaxLen; l >= 1; --l) {
        first[l] = c;
        c = (c + cnt[l]) >> 1;
    }
    std::vector<uint64_t> codes(iM + 1, 0);
    {
        int64_t nxt[kMaxLen + 1];
        std::memcpy(nxt, first, sizeof(nxt));
        for (uint32_t s = 0; s <= iM; ++s)
            if (lens[s]) codes[s] = static_cast<uint64_t>(nxt[lens[s]]++);
    }

    // 14-bit fast table; longer codes found by length-extension search
    std::vector<int32_t> fast(1 << kDecBits, -1);
    std::vector<uint8_t> flen(1 << kDecBits, 0);
    struct LongCode { uint8_t len; uint64_t code; uint32_t sym; };
    std::vector<LongCode> long_codes;
    for (uint32_t s = 0; s <= iM; ++s) {
        int l = lens[s];
        if (!l) continue;
        if (l <= kDecBits) {
            uint64_t lo = codes[s] << (kDecBits - l);
            uint64_t n = 1ull << (kDecBits - l);
            for (uint64_t k = 0; k < n; ++k) {
                fast[lo + k] = static_cast<int32_t>(s);
                flen[lo + k] = static_cast<uint8_t>(l);
            }
        } else {
            long_codes.push_back({static_cast<uint8_t>(l), codes[s], s});
        }
    }

    // decode (byte-aligned after the length table, like the python reader)
    const uint8_t* dat = data;
    int64_t pos = 20 + br.pos;
    // codes may be up to 58 bits and the reader can hold ~65 bits
    // before consuming; 128-bit accumulator avoids dropping top bits
    unsigned __int128 acc = 0;
    int nacc = 0;
    int64_t oi = 0;
    uint64_t used = 0;
    uint16_t last = 0;
    while (oi < n_out && used < n_bits) {
        while (nacc < 30 && pos < len) {
            acc = (acc << 8) | dat[pos++];
            nacc += 8;
        }
        uint64_t peek = static_cast<uint64_t>(
            (nacc >= kDecBits)
            ? (acc >> (nacc - kDecBits)) & ((1ull << kDecBits) - 1)
            : (acc << (kDecBits - nacc)) & ((1ull << kDecBits) - 1));
        int32_t s = fast[peek];
        int l;
        if (s >= 0) {
            l = flen[peek];
            // truncated stream: the zero-padded peek matched a code
            // longer than the bits actually available; consuming it
            // would drive nacc negative (UB in the shifts below)
            if (nacc < l) return 4;
        } else {
            l = -1;
            for (int ll = kDecBits + 1; ll <= kMaxLen; ++ll) {
                while (nacc < ll && pos < len) {
                    acc = (acc << 8) | dat[pos++];
                    nacc += 8;
                }
                if (nacc < ll) break;
                uint64_t cd = static_cast<uint64_t>(
                    (acc >> (nacc - ll)) & (((unsigned __int128)1 << ll) - 1));
                for (const auto& lc2 : long_codes) {
                    if (lc2.len == ll && lc2.code == cd) {
                        s = static_cast<int32_t>(lc2.sym);
                        l = ll;
                        break;
                    }
                }
                if (s >= 0) break;
            }
            if (s < 0) return 4;
        }
        nacc -= l;
        used += l;
        if (static_cast<uint32_t>(s) == iM) {  // RLE: repeat last symbol
            if (nacc < 8) {
                if (pos >= len) return 5;
                acc = (acc << 8) | dat[pos++];
                nacc += 8;
            }
            uint64_t run = static_cast<uint64_t>((acc >> (nacc - 8)) & 0xFF);
            nacc -= 8;
            used += 8;
            if (oi + static_cast<int64_t>(run) > n_out) return 6;
            for (uint64_t k = 0; k < run; ++k) out[oi++] = last;
        } else {
            last = static_cast<uint16_t>(s);
            out[oi++] = last;
        }
    }
    return oi == n_out ? 0 : 7;
}
