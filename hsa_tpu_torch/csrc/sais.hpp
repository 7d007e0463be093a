// SA-IS suffix array construction (induced sorting), from-scratch implementation
// of the algorithm of Nong, Zhang & Chan (DCC'09).
//
// Role in hsa-tpu: native index-construction core, replacing the reference
// lineage's `is.c` (SA-IS for small refs) and `bwt_gen.c` (blockwise BWT for
// large refs) with a single linear-time construction (SURVEY.md §2 "native
// component #1/#2").  Templated on the index type so whole-genome builds
// (n ~ 3.1e9 > 2^31) use int64 while small builds stay in int32.
//
// Convention: the caller passes text codes in 1..K-1 and the function treats
// position n (virtual) as the unique smallest sentinel; the returned SA has
// n+1 entries over text+sentinel, SA[0] == n.  This matches
// hsa_tpu.fmcore.suffix_array exactly.

#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace refpack {

template <typename I, typename S>
struct Sais {
  static bool isLMS(const std::vector<bool>& t, I i) {
    return i > 0 && t[(size_t)i] && !t[(size_t)(i - 1)];
  }

  // s: length n, values in 0..K-1, s[n-1] == 0 unique minimum (sentinel).
  static void core(const S* s, I* SA, I n, I K) {
    std::vector<bool> t((size_t)n);
    t[(size_t)(n - 1)] = true;
    for (I i = n - 2; i >= 0; --i)
      t[(size_t)i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[(size_t)(i + 1)]);

    std::vector<I> bkt((size_t)K);
    auto getBuckets = [&](bool end) {
      std::fill(bkt.begin(), bkt.end(), (I)0);
      for (I i = 0; i < n; ++i) bkt[(size_t)s[i]]++;
      I sum = 0;
      for (I i = 0; i < K; ++i) {
        sum += bkt[(size_t)i];
        bkt[(size_t)i] = end ? sum : sum - bkt[(size_t)i];
      }
    };
    auto induce = [&]() {
      getBuckets(false);
      for (I i = 0; i < n; ++i) {
        I j = SA[i];
        if (j > 0 && !t[(size_t)(j - 1)]) SA[bkt[(size_t)s[j - 1]]++] = j - 1;
      }
      getBuckets(true);
      for (I i = n - 1; i >= 0; --i) {
        I j = SA[i];
        if (j > 0 && t[(size_t)(j - 1)]) SA[--bkt[(size_t)s[j - 1]]] = j - 1;
      }
    };

    // stage 1: sort LMS substrings by induced sorting
    std::fill(SA, SA + n, (I)-1);
    getBuckets(true);
    for (I i = 1; i < n; ++i)
      if (isLMS(t, i)) SA[--bkt[(size_t)s[i]]] = i;
    induce();

    I n1 = 0;
    for (I i = 0; i < n; ++i)
      if (isLMS(t, SA[i])) SA[n1++] = SA[i];

    // name LMS substrings into SA[n1..n)
    std::fill(SA + n1, SA + n, (I)-1);
    I name = 0, prev = -1;
    for (I i = 0; i < n1; ++i) {
      I pos = SA[i];
      bool diff = false;
      for (I d = 0; d < n; ++d) {
        if (prev == -1 || s[pos + d] != s[prev + d] ||
            t[(size_t)(pos + d)] != t[(size_t)(prev + d)]) {
          diff = true;
          break;
        }
        if (d > 0 && (isLMS(t, pos + d) || isLMS(t, prev + d))) break;
      }
      if (diff) {
        ++name;
        prev = pos;
      }
      SA[n1 + pos / 2] = name - 1;
    }
    for (I i = n - 1, j = n - 1; i >= n1; --i)
      if (SA[i] >= 0) SA[j--] = SA[i];

    // stage 2: recurse on the reduced problem if names are not yet unique
    I* s1 = SA + n - n1;
    if (name < n1) {
      core_rec(s1, SA, n1, name);
    } else {
      for (I i = 0; i < n1; ++i) SA[s1[i]] = i;
    }

    // stage 3: induce the full SA from the sorted LMS suffixes
    getBuckets(true);
    for (I i = 1, j = 0; i < n; ++i)
      if (isLMS(t, i)) s1[j++] = i;
    for (I i = 0; i < n1; ++i) SA[i] = s1[SA[i]];
    std::fill(SA + n1, SA + n, (I)-1);
    for (I i = n1 - 1; i >= 0; --i) {
      I j = SA[i];
      SA[i] = (I)-1;
      SA[--bkt[(size_t)s[j]]] = j;
    }
    induce();
  }

  // recursion works on I-typed reduced strings stored inside SA
  static void core_rec(I* s, I* SA, I n, I K) { Sais<I, I>::core(s, SA, n, K); }
};

// Public entry: text codes 0..3 (uint8), length n; writes SA of text+$ into
// sa_out (n+1 entries).  Internally shifts codes to 1..4 and appends the
// sentinel 0.
template <typename I>
inline void suffix_array(const uint8_t* text, I n, I* sa_out) {
  if (n == 0) {
    sa_out[0] = 0;
    return;
  }
  std::vector<uint8_t> s((size_t)n + 1);
  for (I i = 0; i < n; ++i) s[(size_t)i] = (uint8_t)(text[i] + 1);
  s[(size_t)n] = 0;
  Sais<I, uint8_t>::core(s.data(), sa_out, n + 1, (I)5);
}

}  // namespace refpack
