// Host codec of the PyTorch port (quantized_distillation_tpu_torch), a copy
// of the JAX package's csrc/qdt_native.cpp with the same C interface, so
// both packages write the same bytes:
//
// - a canonical-Huffman codec over quantization levels or codebook indices,
//   which the .qdt artifact (utils/artifact.py) writes and reads;
// - sub-byte bit packing in the layout of ops/packing.py (8/bits values per
//   byte, little-endian within the byte);
// - padded-batch assembly of ragged token lists.
//
// Host code, not a kernel: compiled with g++ at first use
// (kernels/_build.py: load_host) and bound from Python with ctypes
// (native/__init__.py). No global state; every function returns -1 on
// invalid arguments rather than aborting.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

// Code lengths from symbol frequencies (classic two-node merge via heap).
// freqs[i] == 0 -> out_len[i] = 0 (symbol absent from the stream).
// A single-symbol alphabet gets length 1. Returns 0 on success.
int qdt_huffman_lengths(const uint64_t* freqs, int32_t n, uint8_t* out_len) {
  if (!freqs || !out_len || n <= 0 || n > (1 << 16)) return -1;
  std::memset(out_len, 0, static_cast<size_t>(n));
  // (freq, tiebreak) min-heap over tree nodes; leaves are 0..n-1.
  struct Node {
    uint64_t freq;
    int32_t order;  // deterministic tiebreak
    int32_t left, right;  // -1 for leaves
    int32_t sym;
  };
  std::vector<Node> nodes;
  nodes.reserve(2 * static_cast<size_t>(n));
  using HeapItem = std::pair<std::pair<uint64_t, int32_t>, int32_t>;
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>> heap;
  int32_t order = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (freqs[i] == 0) continue;
    nodes.push_back({freqs[i], order, -1, -1, i});
    heap.push({{freqs[i], order}, static_cast<int32_t>(nodes.size() - 1)});
    ++order;
  }
  if (nodes.empty()) return 0;
  if (nodes.size() == 1) {
    out_len[nodes[0].sym] = 1;
    return 0;
  }
  while (heap.size() > 1) {
    auto a = heap.top(); heap.pop();
    auto b = heap.top(); heap.pop();
    Node merged{a.first.first + b.first.first, order++, a.second, b.second, -1};
    nodes.push_back(merged);
    heap.push({{merged.freq, merged.order}, static_cast<int32_t>(nodes.size() - 1)});
  }
  // Depth-first assign depths to leaves (explicit stack, tree depth <= n).
  std::vector<std::pair<int32_t, uint8_t>> stack;
  stack.push_back({heap.top().second, 0});
  while (!stack.empty()) {
    auto [idx, depth] = stack.back();
    stack.pop_back();
    const Node& nd = nodes[static_cast<size_t>(idx)];
    if (nd.left < 0) {
      out_len[nd.sym] = depth == 0 ? 1 : depth;  // degenerate root-leaf
    } else {
      stack.push_back({nd.left, static_cast<uint8_t>(depth + 1)});
      stack.push_back({nd.right, static_cast<uint8_t>(depth + 1)});
    }
  }
  return 0;
}

// Canonical code assignment from lengths: codes ordered by (length, symbol).
// Both encoder and decoder derive the identical codebook from the length
// table alone, so the only side info a stream needs is n bytes of lengths.
static int build_canonical(const uint8_t* lens, int32_t n,
                           std::vector<uint32_t>& codes, uint8_t& max_len) {
  codes.assign(static_cast<size_t>(n), 0);
  max_len = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (lens[i] > 32) return -1;
    max_len = std::max(max_len, lens[i]);
  }
  if (max_len == 0) return 0;
  std::vector<uint32_t> count(max_len + 1, 0);
  for (int32_t i = 0; i < n; ++i) count[lens[i]]++;
  count[0] = 0;
  std::vector<uint32_t> next(max_len + 2, 0);
  uint32_t code = 0;
  for (uint8_t l = 1; l <= max_len; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  for (int32_t i = 0; i < n; ++i) {
    if (lens[i]) {
      codes[static_cast<size_t>(i)] = next[lens[i]]++;
      if (codes[static_cast<size_t>(i)] >> lens[i]) return -1;  // overfull
    }
  }
  return 0;
}

// Encode symbols with the canonical code for `lens`. Returns number of BITS
// written, or -1 (invalid symbol / zero-length code / output overflow).
// Output is MSB-first within each byte.
int64_t qdt_huffman_encode(const int32_t* syms, int64_t n_syms,
                           const uint8_t* lens, int32_t alphabet,
                           uint8_t* out, int64_t out_cap) {
  if (!syms || !lens || !out || n_syms < 0 || alphabet <= 0) return -1;
  std::vector<uint32_t> codes;
  uint8_t max_len = 0;
  if (build_canonical(lens, alphabet, codes, max_len)) return -1;
  std::memset(out, 0, static_cast<size_t>(out_cap));
  int64_t bitpos = 0;
  const int64_t cap_bits = out_cap * 8;
  for (int64_t i = 0; i < n_syms; ++i) {
    int32_t s = syms[i];
    if (s < 0 || s >= alphabet || lens[s] == 0) return -1;
    uint8_t l = lens[s];
    if (bitpos + l > cap_bits) return -1;
    uint32_t c = codes[static_cast<size_t>(s)];
    for (int8_t b = l - 1; b >= 0; --b) {
      if ((c >> b) & 1u)
        out[bitpos >> 3] |= static_cast<uint8_t>(0x80u >> (bitpos & 7));
      ++bitpos;
    }
  }
  return bitpos;
}

// Decode exactly n_out symbols. Returns symbols decoded, or -1 on malformed
// input. Table-driven: one (first_code, first_index) pair per length.
int64_t qdt_huffman_decode(const uint8_t* in, int64_t n_bits,
                           const uint8_t* lens, int32_t alphabet,
                           int32_t* out, int64_t n_out) {
  if (!in || !lens || !out || alphabet <= 0 || n_out < 0) return -1;
  std::vector<uint32_t> codes;
  uint8_t max_len = 0;
  if (build_canonical(lens, alphabet, codes, max_len)) return -1;
  if (max_len == 0) return n_out == 0 ? 0 : -1;
  // Symbols sorted by (length, symbol); per-length first code + offset.
  std::vector<int32_t> sorted;
  sorted.reserve(static_cast<size_t>(alphabet));
  std::vector<int32_t> first_idx(max_len + 1, 0);
  std::vector<uint32_t> first_code(max_len + 1, 0);
  for (uint8_t l = 1; l <= max_len; ++l) {
    first_idx[l] = static_cast<int32_t>(sorted.size());
    bool seen = false;
    for (int32_t s = 0; s < alphabet; ++s) {
      if (lens[s] == l) {
        if (!seen) { first_code[l] = codes[static_cast<size_t>(s)]; seen = true; }
        sorted.push_back(s);
      }
    }
    if (!seen) first_code[l] = 0xFFFFFFFFu;  // no codes at this length
  }
  std::vector<int32_t> count(max_len + 1, 0);
  for (int32_t s = 0; s < alphabet; ++s) if (lens[s]) count[lens[s]]++;

  int64_t bitpos = 0;
  for (int64_t i = 0; i < n_out; ++i) {
    uint32_t code = 0;
    uint8_t l = 0;
    while (true) {
      if (bitpos >= n_bits || l >= max_len + 1) return -1;
      code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1u);
      ++bitpos;
      ++l;
      if (count[l] && code >= first_code[l] &&
          code < first_code[l] + static_cast<uint32_t>(count[l])) {
        out[i] = sorted[static_cast<size_t>(
            first_idx[l] + static_cast<int32_t>(code - first_code[l]))];
        break;
      }
    }
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Sub-byte packing (layout identical to ops/packing.py: f = 8/bits values
// per byte, value k of a group in bits [k*bits, (k+1)*bits)).
// ---------------------------------------------------------------------------

int64_t qdt_pack(const int32_t* levels, int64_t n, int32_t bits, uint8_t* out) {
  if (!levels || !out || (bits != 2 && bits != 4 && bits != 8)) return -1;
  const int32_t f = 8 / bits;
  if (n % f) return -1;
  const int64_t n_bytes = n / f;
  const uint32_t mask = (1u << bits) - 1u;
  for (int64_t i = 0; i < n_bytes; ++i) {
    uint32_t byte = 0;
    for (int32_t k = 0; k < f; ++k) {
      uint32_t v = static_cast<uint32_t>(levels[i * f + k]);
      if (v > mask) return -1;
      byte |= v << (k * bits);
    }
    out[i] = static_cast<uint8_t>(byte);
  }
  return n_bytes;
}

int64_t qdt_unpack(const uint8_t* in, int64_t n_bytes, int32_t bits,
                   int32_t* out) {
  if (!in || !out || (bits != 2 && bits != 4 && bits != 8)) return -1;
  const int32_t f = 8 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  for (int64_t i = 0; i < n_bytes; ++i) {
    const uint32_t byte = in[i];
    for (int32_t k = 0; k < f; ++k)
      out[i * f + k] = static_cast<int32_t>((byte >> (k * bits)) & mask);
  }
  return n_bytes * f;
}

// ---------------------------------------------------------------------------
// Batch assembly: ragged token stream -> padded [B, max_len] + lengths.
// (reference: onmt/IO.py collation, done per batch in Python there.)
// ---------------------------------------------------------------------------

int qdt_pad_batch(const int32_t* flat, const int64_t* offsets, int32_t b,
                  int32_t max_len, int32_t pad, int32_t* out, int32_t* lens) {
  if (!flat || !offsets || !out || !lens || b <= 0 || max_len <= 0) return -1;
  for (int32_t i = 0; i < b; ++i) {
    const int64_t start = offsets[i], end = offsets[i + 1];
    if (end < start) return -1;
    const int32_t n = static_cast<int32_t>(
        std::min<int64_t>(end - start, max_len));
    std::memcpy(out + static_cast<int64_t>(i) * max_len, flat + start,
                static_cast<size_t>(n) * sizeof(int32_t));
    for (int32_t t = n; t < max_len; ++t)
      out[static_cast<int64_t>(i) * max_len + t] = pad;
    lens[i] = n;
  }
  return 0;
}

}  // extern "C"
