// KvEmbeddingStore: native hash-table embedding store for elastic sparse
// training on TPU hosts.
//
// Parity: tfplus KvVariable (tfplus/tfplus/kv_variable/kernels/
// kv_variable_ops.cc:1164, kv_variable.h:1021, hashmap.h:1030) and its
// fused sparse optimizers (kernels/training_ops.cc). Re-designed for the
// TPU recommender shape: the table lives in HOST memory (TPU HBM holds
// the dense model; embedding rows are gathered host-side and fed to the
// chip per step), so the native layer is a plain shared library driven
// through ctypes — no TF op registry, no resource-variable machinery.
//
// Design:
// - NUM_BUCKETS internal shards, each its own mutex + open hash map:
//   concurrent gathers/updates from data-loader threads don't serialize.
// - A row = [value(dim) | slot_0(dim) | ... ]: optimizer slots
//   (Adagrad/Momentum accumulators) live beside the value, so a fused
//   sparse update touches one cache-resident row (the reference keeps
//   slots in separate KvVariables and pays two lookups).
// - Every row carries frequency, last-access timestamp and the global
//   mutation version at its last write: full export = export(since=0),
//   delta export = export(since=v) (parity: FullOrDeltaImport/Export
//   ops, kv_variable_ops.cc:733) — the primitive elastic resharding and
//   incremental checkpoints are built on.
// - Missing keys on gather are initialized from a splitmix64 hash of
//   (seed, key): deterministic across shards/restarts, no RNG state.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <unistd.h>  // ftruncate, fileno
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNumBuckets = 64;

struct Row {
  std::vector<float> data;  // dim * (1 + num_slots)
  int64_t freq = 0;
  int64_t ts = 0;
  uint64_t version = 0;
};

struct Bucket {
  std::mutex mu;
  std::unordered_map<int64_t, Row> map;
};

struct Store {
  int64_t dim;
  int num_slots;
  uint64_t seed;
  float init_scale;
  Bucket buckets[kNumBuckets];
  std::mutex version_mu;
  uint64_t version = 0;  // global mutation counter

  uint64_t next_version() {
    std::lock_guard<std::mutex> g(version_mu);
    return ++version;
  }
  int64_t row_floats() const { return dim * (1 + num_slots); }
  Bucket& bucket(int64_t key) {
    // splitmix-style mix so sequential ids spread across buckets
    uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ULL;
    return buckets[(h >> 32) % kNumBuckets];
  }
};

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

void init_row(const Store* s, int64_t key, float* out) {
  // deterministic pseudo-normal init (sum of uniforms), scaled
  uint64_t state = splitmix64(s->seed ^ static_cast<uint64_t>(key));
  for (int64_t i = 0; i < s->dim; ++i) {
    float acc = 0.f;
    for (int k = 0; k < 4; ++k) {
      state = splitmix64(state);
      acc += static_cast<float>(state >> 40) /
             static_cast<float>(1ULL << 24);  // [0,1)
    }
    out[i] = (acc - 2.0f) * 1.7320508f * s->init_scale;  // ~N(0, scale)
  }
  std::memset(out + s->dim, 0, sizeof(float) * s->dim * s->num_slots);
}

Row& find_or_create(Store* s, Bucket& b, int64_t key, int64_t now,
                    bool* created) {
  auto it = b.map.find(key);
  if (it == b.map.end()) {
    Row row;
    row.data.resize(s->row_floats());
    init_row(s, key, row.data.data());
    row.ts = now;
    row.version = s->next_version();
    it = b.map.emplace(key, std::move(row)).first;
    if (created) *created = true;
  } else if (created) {
    *created = false;
  }
  return it->second;
}

}  // namespace

extern "C" {

void* kv_create(int64_t dim, int num_slots, uint64_t seed,
                float init_scale) {
  Store* s = new Store();
  s->dim = dim;
  s->num_slots = num_slots;
  s->seed = seed;
  s->init_scale = init_scale;
  return s;
}

void kv_free(void* h) { delete static_cast<Store*>(h); }

int64_t kv_size(void* h) {
  Store* s = static_cast<Store*>(h);
  int64_t n = 0;
  for (auto& b : s->buckets) {
    std::lock_guard<std::mutex> g(b.mu);
    n += static_cast<int64_t>(b.map.size());
  }
  return n;
}

uint64_t kv_version(void* h) {
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->version_mu);
  return s->version;
}

// Gather values (NOT slots) for n keys into out[n*dim]. insert_missing:
// initialize absent keys (GatherOrInsert); otherwise absent keys read 0.
// Bumps freq and ts of every touched key.
void kv_gather(void* h, const int64_t* keys, int64_t n, float* out,
               int insert_missing, int64_t now) {
  Store* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    if (insert_missing) {
      Row& row = find_or_create(s, b, keys[i], now, nullptr);
      row.freq++;
      row.ts = now;
      std::memcpy(out + i * s->dim, row.data.data(),
                  sizeof(float) * s->dim);
    } else {
      auto it = b.map.find(keys[i]);
      if (it == b.map.end()) {
        std::memset(out + i * s->dim, 0, sizeof(float) * s->dim);
      } else {
        it->second.freq++;
        it->second.ts = now;
        std::memcpy(out + i * s->dim, it->second.data.data(),
                    sizeof(float) * s->dim);
      }
    }
  }
}

// op: 0=update 1=add 2=sub 3=mul 4=div 5=min 6=max   (parity:
// KvVariableScatter{Update,Add,Sub,Mul,Div,Min,Max}V2)
void kv_scatter(void* h, const int64_t* keys, int64_t n,
                const float* vals, int op, int64_t now) {
  Store* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* v = row.data.data();
    const float* u = vals + i * s->dim;
    for (int64_t d = 0; d < s->dim; ++d) {
      switch (op) {
        case 0: v[d] = u[d]; break;
        case 1: v[d] += u[d]; break;
        case 2: v[d] -= u[d]; break;
        case 3: v[d] *= u[d]; break;
        case 4: v[d] /= u[d]; break;
        case 5: v[d] = v[d] < u[d] ? v[d] : u[d]; break;
        case 6: v[d] = v[d] > u[d] ? v[d] : u[d]; break;
      }
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse Adagrad (parity: training_ops.cc KvSparseApplyAdagrad):
// slot0 += g^2 ; value -= lr * g / (sqrt(slot0) + eps). Requires
// num_slots >= 1. Duplicate keys in one batch accumulate sequentially
// (same as the reference's row-locked apply).
void kv_sparse_adagrad(void* h, const int64_t* keys, int64_t n,
                       const float* grads, float lr, float eps,
                       int64_t now) {
  Store* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* v = row.data.data();
    float* acc = v + s->dim;
    const float* gr = grads + i * s->dim;
    for (int64_t d = 0; d < s->dim; ++d) {
      acc[d] += gr[d] * gr[d];
      v[d] -= lr * gr[d] / (__builtin_sqrtf(acc[d]) + eps);
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse momentum-SGD: slot0 = momentum*slot0 + g;
// value -= lr*slot0. Requires num_slots >= 1.
void kv_sparse_momentum(void* h, const int64_t* keys, int64_t n,
                        const float* grads, float lr, float momentum,
                        int64_t now) {
  Store* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* v = row.data.data();
    float* m = v + s->dim;
    const float* gr = grads + i * s->dim;
    for (int64_t d = 0; d < s->dim; ++d) {
      m[d] = momentum * m[d] + gr[d];
      v[d] -= lr * m[d];
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse Adam (parity: training_ops.cc group/sparse Adam family):
// slot0 = m, slot1 = v; bias-corrected update using the caller's step
// count. Requires num_slots >= 2.
void kv_sparse_adam(void* h, const int64_t* keys, int64_t n,
                    const float* grads, float lr, float beta1,
                    float beta2, float eps, int64_t step, int64_t now) {
  Store* s = static_cast<Store*>(h);
  const float bc1 = 1.0f - __builtin_powf(beta1, (float)step);
  const float bc2 = 1.0f - __builtin_powf(beta2, (float)step);
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* w = row.data.data();
    float* m = w + s->dim;
    float* v = w + 2 * s->dim;
    const float* gr = grads + i * s->dim;
    for (int64_t d = 0; d < s->dim; ++d) {
      m[d] = beta1 * m[d] + (1.0f - beta1) * gr[d];
      v[d] = beta2 * v[d] + (1.0f - beta2) * gr[d] * gr[d];
      const float mhat = m[d] / bc1;
      const float vhat = v[d] / bc2;
      w[d] -= lr * mhat / (__builtin_sqrtf(vhat) + eps);
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse group-lasso FTRL (parity: the "Group Adam/Adagrad" paper
// ops in training_ops.cc / sparse_group_ftrl.py): per-coordinate FTRL
// accumulators (slot0 = n, slot1 = z) with an L2,1 group penalty that
// zeroes WHOLE embedding rows of rarely-useful keys — the sparsity the
// reference's recommender workloads rely on. Requires num_slots >= 2.
void kv_sparse_group_ftrl(void* h, const int64_t* keys, int64_t nkeys,
                          const float* grads, float alpha, float beta,
                          float l1, float l21, int64_t now) {
  Store* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < nkeys; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* w = row.data.data();
    float* acc = w + s->dim;  // n accumulator
    float* z = w + 2 * s->dim;
    const float* gr = grads + i * s->dim;
    // First FTRL touch of a row created by gather (random init, zero
    // accumulators): seed z so the proximal solve reproduces the
    // initial weights (z = -w*(beta+sqrt(n))/alpha, TF Ftrl's init
    // convention; exact when l1=l21=0). Without this the random init
    // would leak into z as a permanent bias AND be discarded from w.
    {
      bool untouched = true;
      for (int64_t d = 0; d < s->dim && untouched; ++d)
        untouched = acc[d] == 0.0f && z[d] == 0.0f;
      if (untouched) {
        for (int64_t d = 0; d < s->dim; ++d) z[d] = -w[d] * beta / alpha;
      }
    }
    // accumulate, then solve the proximal step for the whole row
    for (int64_t d = 0; d < s->dim; ++d) {
      const float n_new = acc[d] + gr[d] * gr[d];
      const float sigma =
          (__builtin_sqrtf(n_new) - __builtin_sqrtf(acc[d])) / alpha;
      z[d] += gr[d] - sigma * w[d];
      acc[d] = n_new;
    }
    // per-coordinate soft threshold (l1), collect row norm of the
    // thresholded pseudo-weights
    float norm2 = 0.0f;
    for (int64_t d = 0; d < s->dim; ++d) {
      const float zd = z[d];
      const float sgn = zd > 0.f ? 1.f : (zd < 0.f ? -1.f : 0.f);
      const float mag = zd * sgn - l1;  // |z| - l1
      const float u = mag > 0.f ? sgn * mag : 0.f;
      w[d] = u;  // stash u; scaled below
      norm2 += u * u;
    }
    const float norm = __builtin_sqrtf(norm2);
    const float group = norm > l21 ? (1.0f - l21 / norm) : 0.0f;
    for (int64_t d = 0; d < s->dim; ++d) {
      const float denom = (beta + __builtin_sqrtf(acc[d])) / alpha;
      w[d] = -group * w[d] / denom;
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse Group Adam (parity: training_ops.cc
// KvVariableGroupSparseApplyAdamNewV2, python group_adam.py — the
// "Adaptive Optimizers with Sparse Group Lasso" construction): Adam
// moments drive an FTRL-style linear accumulator, and the weight is the
// CLOSED-FORM solution of the proximal problem with elementwise L1,
// ridge L2 and row-group L2,1 penalties — rarely-useful keys collapse to
// exact zero rows. Slots: 0=linear, 1=m, 2=v (num_slots >= 3).
void kv_sparse_group_adam(void* h, const int64_t* keys, int64_t nkeys,
                          const float* grads, float lr, float beta1,
                          float beta2, float eps, float l1, float l2,
                          float l21, int64_t step, int64_t now) {
  Store* s = static_cast<Store*>(h);
  const float b1p = __builtin_powf(beta1, (float)step);
  const float b2p = __builtin_powf(beta2, (float)step);
  const float alpha = __builtin_sqrtf(1.0f - b2p) / (1.0f - b1p);
  const float l21_norm =
      l21 * __builtin_sqrtf(static_cast<float>(s->dim));
  for (int64_t i = 0; i < nkeys; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* w = row.data.data();
    float* linear = w + s->dim;
    float* m = w + 2 * s->dim;
    float* v = w + 3 * s->dim;
    const float* gr = grads + i * s->dim;
    float norm2 = 0.0f;
    for (int64_t d = 0; d < s->dim; ++d) {
      m[d] = beta1 * m[d] + (1.0f - beta1) * gr[d];
      const float new_v =
          beta2 * v[d] + (1.0f - beta2) * gr[d] * gr[d];
      // the reference drops eps from the sigma term after step 1
      // (beta1 > beta1^t), keeping it only for the t=1 edge
      const float sigma =
          (__builtin_sqrtf(new_v) - __builtin_sqrtf(v[d]) +
           (beta1 > b1p ? 0.0f : eps)) /
          lr;
      linear[d] += alpha * m[d] - sigma * w[d];
      v[d] = new_v;
      const float clipped =
          linear[d] > l1 ? l1 : (linear[d] < -l1 ? -l1 : linear[d]);
      const float u = clipped - linear[d];  // soft-thresholded direction
      w[d] = u;  // stash; scaled (or zeroed) below
      norm2 += u * u;
    }
    const float norm = __builtin_sqrtf(norm2);
    if (norm > l21_norm) {
      const float scale = 1.0f - l21_norm / norm;
      for (int64_t d = 0; d < s->dim; ++d) {
        const float y =
            (__builtin_sqrtf(v[d]) + eps) / lr + 2.0f * l2;
        w[d] = w[d] * scale / y;
      }
    } else {
      // group lasso zeroes the whole row (the reference blacklists the
      // key; here the zero row IS the tombstone — eviction reclaims it)
      std::memset(w, 0, sizeof(float) * s->dim);
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse LAMB (parity: training_ops.cc sparse Lamb family /
// python lamb_optimizer.py): Adam direction with decoupled weight decay,
// rescaled per EMBEDDING ROW by the trust ratio ||w|| / ||update|| — the
// row is the natural "layer" of a kv table. Slots: 0=m, 1=v.
void kv_sparse_lamb(void* h, const int64_t* keys, int64_t nkeys,
                    const float* grads, float lr, float beta1,
                    float beta2, float eps, float weight_decay,
                    int64_t step, int64_t now) {
  Store* s = static_cast<Store*>(h);
  const float bc1 = 1.0f - __builtin_powf(beta1, (float)step);
  const float bc2 = 1.0f - __builtin_powf(beta2, (float)step);
  std::vector<float> r(s->dim);
  for (int64_t i = 0; i < nkeys; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* w = row.data.data();
    float* m = w + s->dim;
    float* v = w + 2 * s->dim;
    const float* gr = grads + i * s->dim;
    float wnorm2 = 0.0f, rnorm2 = 0.0f;
    for (int64_t d = 0; d < s->dim; ++d) {
      m[d] = beta1 * m[d] + (1.0f - beta1) * gr[d];
      v[d] = beta2 * v[d] + (1.0f - beta2) * gr[d] * gr[d];
      const float mhat = m[d] / bc1;
      const float vhat = v[d] / bc2;
      r[d] = mhat / (__builtin_sqrtf(vhat) + eps) + weight_decay * w[d];
      wnorm2 += w[d] * w[d];
      rnorm2 += r[d] * r[d];
    }
    const float wn = __builtin_sqrtf(wnorm2);
    const float rn = __builtin_sqrtf(rnorm2);
    const float ratio = (wn > 0.0f && rn > 0.0f) ? wn / rn : 1.0f;
    for (int64_t d = 0; d < s->dim; ++d) w[d] -= lr * ratio * r[d];
    row.ts = now;
    row.version = s->next_version();
  }
}

// Fused sparse AdaBelief (parity: atorch low-bit optim family's
// AdaBelief / tfplus adabelief): second moment tracks the variance of
// the gradient around its EMA — (g - m)^2 — so steps grow where the
// gradient is consistent and shrink where it is noisy.
// Slots: 0=m, 1=s.
void kv_sparse_adabelief(void* h, const int64_t* keys, int64_t nkeys,
                         const float* grads, float lr, float beta1,
                         float beta2, float eps, int64_t step,
                         int64_t now) {
  Store* s_ = static_cast<Store*>(h);
  const float bc1 = 1.0f - __builtin_powf(beta1, (float)step);
  const float bc2 = 1.0f - __builtin_powf(beta2, (float)step);
  for (int64_t i = 0; i < nkeys; ++i) {
    Bucket& b = s_->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s_, b, keys[i], now, nullptr);
    float* w = row.data.data();
    float* m = w + s_->dim;
    float* sv = w + 2 * s_->dim;
    const float* gr = grads + i * s_->dim;
    for (int64_t d = 0; d < s_->dim; ++d) {
      m[d] = beta1 * m[d] + (1.0f - beta1) * gr[d];
      const float diff = gr[d] - m[d];
      sv[d] = beta2 * sv[d] + (1.0f - beta2) * diff * diff + eps;
      const float mhat = m[d] / bc1;
      const float shat = sv[d] / bc2;
      w[d] -= lr * mhat / (__builtin_sqrtf(shat) + eps);
    }
    row.ts = now;
    row.version = s_->next_version();
  }
}

// Fused sparse AMSGrad (parity: tfplus adam family with amsgrad):
// Adam with a monotone max over the second moment, so the effective LR
// never grows back after a large gradient. Slots: 0=m, 1=v, 2=vmax
// (num_slots >= 3).
void kv_sparse_amsgrad(void* h, const int64_t* keys, int64_t nkeys,
                       const float* grads, float lr, float beta1,
                       float beta2, float eps, int64_t step,
                       int64_t now) {
  Store* s = static_cast<Store*>(h);
  const float bc1 = 1.0f - __builtin_powf(beta1, (float)step);
  const float bc2 = 1.0f - __builtin_powf(beta2, (float)step);
  for (int64_t i = 0; i < nkeys; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = find_or_create(s, b, keys[i], now, nullptr);
    float* w = row.data.data();
    float* m = w + s->dim;
    float* v = w + 2 * s->dim;
    float* vmax = w + 3 * s->dim;
    const float* gr = grads + i * s->dim;
    for (int64_t d = 0; d < s->dim; ++d) {
      m[d] = beta1 * m[d] + (1.0f - beta1) * gr[d];
      v[d] = beta2 * v[d] + (1.0f - beta2) * gr[d] * gr[d];
      if (v[d] > vmax[d]) vmax[d] = v[d];
      const float mhat = m[d] / bc1;
      const float vhat = vmax[d] / bc2;
      w[d] -= lr * mhat / (__builtin_sqrtf(vhat) + eps);
    }
    row.ts = now;
    row.version = s->next_version();
  }
}

// Export rows whose version > since (0 = full export). Two-phase: count,
// then fill caller-allocated buffers. Rows: full row incl. slots.
int64_t kv_export_count(void* h, uint64_t since) {
  Store* s = static_cast<Store*>(h);
  int64_t n = 0;
  for (auto& b : s->buckets) {
    std::lock_guard<std::mutex> g(b.mu);
    for (auto& kv : b.map)
      if (kv.second.version > since) ++n;
  }
  return n;
}

int64_t kv_export(void* h, uint64_t since, int64_t* keys_out,
                  float* rows_out, int64_t* freq_out, int64_t* ts_out,
                  int64_t capacity) {
  Store* s = static_cast<Store*>(h);
  int64_t rf = s->row_floats();
  int64_t n = 0;
  for (auto& b : s->buckets) {
    std::lock_guard<std::mutex> g(b.mu);
    for (auto& kv : b.map) {
      if (kv.second.version <= since) continue;
      if (n >= capacity) return -1;  // caller raced a writer; retry
      keys_out[n] = kv.first;
      std::memcpy(rows_out + n * rf, kv.second.data.data(),
                  sizeof(float) * rf);
      freq_out[n] = kv.second.freq;
      ts_out[n] = kv.second.ts;
      ++n;
    }
  }
  return n;
}

// Import rows (full row incl. slots). Overwrites existing keys.
void kv_import(void* h, const int64_t* keys, int64_t n,
               const float* rows, const int64_t* freq,
               const int64_t* ts) {
  Store* s = static_cast<Store*>(h);
  int64_t rf = s->row_floats();
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    Row& row = b.map[keys[i]];
    row.data.assign(rows + i * rf, rows + (i + 1) * rf);
    row.freq = freq ? freq[i] : 0;
    row.ts = ts ? ts[i] : 0;
    row.version = s->next_version();
  }
}

// List every live key (no values, no freq/ts bump): the cheap first
// pass of a warm reshard — 8 bytes per row instead of the full
// row_floats export, so ownership can be recomputed over millions of
// rows before any row data moves. Returns the count, or -1 when the
// caller's buffer raced a concurrent insert and is too small (retry
// with a fresh kv_size).
int64_t kv_export_keys(void* h, int64_t* keys_out, int64_t capacity) {
  Store* s = static_cast<Store*>(h);
  int64_t n = 0;
  for (auto& b : s->buckets) {
    std::lock_guard<std::mutex> g(b.mu);
    for (auto& kv : b.map) {
      if (n >= capacity) return -1;
      keys_out[n++] = kv.first;
    }
  }
  return n;
}

// Export full rows (values + slots + freq/ts) for exactly the given
// keys — the move leg of a warm reshard and the device hot tier's
// fault-in read. Absent keys zero their row and mark freq_out = -1;
// freq/ts are NOT bumped (this is a state read, not an access).
// Returns the number of keys found.
int64_t kv_export_rows(void* h, const int64_t* keys, int64_t n,
                       float* rows_out, int64_t* freq_out,
                       int64_t* ts_out) {
  Store* s = static_cast<Store*>(h);
  int64_t rf = s->row_floats();
  int64_t found = 0;
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    auto it = b.map.find(keys[i]);
    if (it == b.map.end()) {
      std::memset(rows_out + i * rf, 0, sizeof(float) * rf);
      freq_out[i] = -1;
      ts_out[i] = -1;
    } else {
      std::memcpy(rows_out + i * rf, it->second.data.data(),
                  sizeof(float) * rf);
      freq_out[i] = it->second.freq;
      ts_out[i] = it->second.ts;
      ++found;
    }
  }
  return found;
}

// Delete exactly the given keys (the hand-off leg of a warm reshard:
// rows exported to their new owner leave the old shard). Returns the
// number actually removed.
int64_t kv_delete_keys(void* h, const int64_t* keys, int64_t n) {
  Store* s = static_cast<Store*>(h);
  int64_t removed = 0;
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    removed += static_cast<int64_t>(b.map.erase(keys[i]));
  }
  return removed;
}

// Evict rows last touched before ts_limit (parity:
// KvVariableDeleteWithTimestamp). Returns evicted count.
int64_t kv_delete_before_timestamp(void* h, int64_t ts_limit) {
  Store* s = static_cast<Store*>(h);
  int64_t n = 0;
  for (auto& b : s->buckets) {
    std::lock_guard<std::mutex> g(b.mu);
    for (auto it = b.map.begin(); it != b.map.end();) {
      if (it->second.ts < ts_limit) {
        it = b.map.erase(it);
        ++n;
      } else {
        ++it;
      }
    }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native cold tier (hybrid embedding spill store).
//
// Parity: tfplus hybrid_embedding keeps the TIER MANAGER native
// (table_manager.h:547, storage_table.h:199): the hot->cold eviction and
// cold->hot fault-in move rows entirely inside C++ — one pass over the
// buckets, no per-row Python/sqlite marshaling — which is what makes
// recommender-scale gathers with faulting viable. The cold tier is an
// append-only spill log (fixed header + row floats; tombstones on
// fault-in) with an in-memory index rebuilt by a single scan at open, so
// it survives restarts and compacts naturally on rewrite.
//
// Concurrency contract: the embedding wrapper's tier lock (tiered.py
// _RWLock) serializes tier MOVES against gathers; within that contract
// the cold store needs only its own mutex for file/index access.
//
// Failed writes (this copy's repair of the reference's log): the log is
// unbuffered and each record is one write, so the bytes on disk are what
// the writes reported. An append that fails (a short write: ENOSPC, a
// file-size limit) cuts the log back to where the record began, so the
// next append never lands after a torn record; a log that cannot be cut
// marks the store failed, and it refuses every later append. An eviction
// that fails in any bucket rolls the whole call back (the log, the index
// and the max seq): every row of the call stays hot, and the same seq can
// run again.
// ---------------------------------------------------------------------------

namespace {

struct ColdRecHeader {
  int64_t key;
  int64_t freq;
  int64_t ts;
  int64_t seq;
  int64_t kind;  // 1 = row payload follows, 0 = tombstone
};

struct ColdEnt {
  int64_t offset;  // file offset of the row payload
  int64_t freq;
  int64_t ts;
  int64_t seq;
};

struct ColdStore {
  std::mutex mu;
  std::FILE* f = nullptr;
  int64_t row_floats = 0;
  int64_t max_seq = 0;
  bool failed = false;  // the log could not be cut back after a failed write
  std::unordered_map<int64_t, ColdEnt> index;
  std::vector<char> rec;  // one record's bytes, written at once
};

int64_t cold_end(ColdStore* c) {
  std::fseek(c->f, 0, SEEK_END);
  return static_cast<int64_t>(std::ftell(c->f));
}

// Cut the log back to `size` bytes; false (and the store failed) if it
// cannot be cut.
bool cold_truncate(ColdStore* c, int64_t size) {
  std::clearerr(c->f);
  if (ftruncate(fileno(c->f), static_cast<off_t>(size)) != 0) {
    c->failed = true;
    return false;
  }
  std::fseek(c->f, static_cast<long>(size), SEEK_SET);
  return true;
}

bool cold_append(ColdStore* c, const ColdRecHeader& hdr,
                 const float* row) {
  if (c->failed) return false;
  const int64_t start = cold_end(c);
  const size_t payload_bytes =
      hdr.kind == 1 ? sizeof(float) * static_cast<size_t>(c->row_floats) : 0;
  c->rec.resize(sizeof(hdr) + payload_bytes);
  std::memcpy(c->rec.data(), &hdr, sizeof(hdr));
  if (payload_bytes) std::memcpy(c->rec.data() + sizeof(hdr), row, payload_bytes);
  if (std::fwrite(c->rec.data(), 1, c->rec.size(), c->f) != c->rec.size()) {
    cold_truncate(c, start);  // no torn record stays in the log
    return false;
  }
  if (hdr.kind == 1) {
    c->index[hdr.key] =
        ColdEnt{start + static_cast<int64_t>(sizeof(hdr)), hdr.freq, hdr.ts, hdr.seq};
  } else {
    c->index.erase(hdr.key);
  }
  if (hdr.seq > c->max_seq) c->max_seq = hdr.seq;
  return true;
}

}  // namespace

extern "C" {

// Open (creating if absent) a spill log; rebuilds the index by scan.
// Returns nullptr when the file cannot be opened or is malformed for
// this row size.
void* cold_open(const char* path, int64_t row_floats) {
  std::FILE* f = std::fopen(path, "r+b");
  if (!f) f = std::fopen(path, "w+b");
  if (!f) return nullptr;
  // unbuffered: a record's bytes reach the file in its own write, so a
  // failed write is seen (and cut back) at that record
  std::setvbuf(f, nullptr, _IONBF, 0);
  ColdStore* c = new ColdStore();
  c->f = f;
  c->row_floats = row_floats;
  std::fseek(f, 0, SEEK_END);
  const int64_t fsize = std::ftell(f);
  const int64_t row_bytes =
      static_cast<int64_t>(sizeof(float)) * row_floats;
  std::fseek(f, 0, SEEK_SET);
  int64_t off = 0;
  ColdRecHeader hdr;
  // crash recovery: a record torn mid-append (writer died between the
  // header and the payload landing) is the un-completed tail of the
  // log — drop it and every byte after it, keep everything before.
  // (fseek past EOF SUCCEEDS on binary streams, so truncation must be
  // detected against the byte count, not a seek failure.)
  while (off + static_cast<int64_t>(sizeof(hdr)) <= fsize) {
    if (std::fread(&hdr, sizeof(hdr), 1, f) != 1) break;
    off += static_cast<int64_t>(sizeof(hdr));
    if (hdr.kind == 1) {
      if (off + row_bytes > fsize) break;  // torn payload: drop tail
      c->index[hdr.key] = ColdEnt{off, hdr.freq, hdr.ts, hdr.seq};
      off += row_bytes;
      std::fseek(f, static_cast<long>(off), SEEK_SET);
    } else {
      c->index.erase(hdr.key);
    }
    if (hdr.seq > c->max_seq) c->max_seq = hdr.seq;
  }
  return c;
}

void cold_close(void* h) {
  ColdStore* c = static_cast<ColdStore*>(h);
  if (c->f) std::fclose(c->f);
  delete c;
}

int64_t cold_count(void* h) {
  ColdStore* c = static_cast<ColdStore*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  return static_cast<int64_t>(c->index.size());
}

int64_t cold_max_seq(void* h) {
  ColdStore* c = static_cast<ColdStore*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  return c->max_seq;
}

// Move every hot row last touched before ts_limit into the cold log,
// stamped with eviction sequence `seq`. Returns the number moved (or
// -1 on a write error; then no row of the call left the hot store, the
// log, its index and max seq are as before the call, and the same seq
// can run again). Every bucket is held for the call: the rows are
// written first and leave the hot store only once all are in the log.
int64_t kv_evict_to_cold(void* hot_h, void* cold_h, int64_t ts_limit,
                         int64_t seq) {
  Store* s = static_cast<Store*>(hot_h);
  ColdStore* c = static_cast<ColdStore*>(cold_h);
  std::lock_guard<std::mutex> cg(c->mu);
  if (c->failed) return -1;
  std::vector<std::unique_lock<std::mutex>> held;
  held.reserve(kNumBuckets);
  for (auto& b : s->buckets) held.emplace_back(b.mu);
  const int64_t start = cold_end(c);
  const int64_t max_seq = c->max_seq;
  // (bucket, key) of each row written, and the index entry it replaced
  std::vector<std::pair<Bucket*, int64_t>> rows;
  std::vector<std::pair<int64_t, ColdEnt>> replaced;
  std::vector<int64_t> added;
  for (auto& b : s->buckets) {
    for (auto& kv : b.map) {
      if (kv.second.ts >= ts_limit) continue;
      auto old = c->index.find(kv.first);
      if (old != c->index.end()) replaced.emplace_back(*old);
      else added.push_back(kv.first);
      ColdRecHeader hdr{kv.first, kv.second.freq, kv.second.ts, seq, 1};
      if (!cold_append(c, hdr, kv.second.data.data())) {
        // roll the call back: the log to its start, the index, max seq
        if (!c->failed) cold_truncate(c, start);
        for (int64_t k : added) c->index.erase(k);
        for (auto& e : replaced) c->index[e.first] = e.second;
        c->max_seq = max_seq;
        return -1;
      }
      rows.emplace_back(&b, kv.first);
    }
  }
  for (auto& r : rows) r.first->map.erase(r.second);
  return static_cast<int64_t>(rows.size());
}

// Fault keys present in the cold tier back into the hot store (values
// AND optimizer slots travel; freq/ts preserved), tombstoning them in
// the log. Keys not in the cold tier are ignored. A key that is already
// hot keeps its hot row (this copy's repair of the reference, which
// assigned the cold row over it): a row written hot after its eviction,
// such as a device tier's spill, is newer than its cold record, so the
// cold record is only tombstoned. Returns the number of rows moved hot
// (or -1 on an IO error; a row whose tombstone failed is then hot and
// still in the log).
int64_t kv_fault_from_cold(void* hot_h, void* cold_h,
                           const int64_t* keys, int64_t n) {
  Store* s = static_cast<Store*>(hot_h);
  ColdStore* c = static_cast<ColdStore*>(cold_h);
  int64_t rf = s->row_floats();
  int64_t moved = 0;
  std::lock_guard<std::mutex> cg(c->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = c->index.find(keys[i]);
    if (it == c->index.end()) continue;
    bool was_cold = false;
    {
      Bucket& b = s->bucket(keys[i]);
      std::lock_guard<std::mutex> g(b.mu);
      if (b.map.find(keys[i]) == b.map.end()) {
        Row r;
        r.data.resize(static_cast<size_t>(rf));
        if (std::fseek(c->f, static_cast<long>(it->second.offset),
                       SEEK_SET) != 0)
          return -1;
        if (std::fread(r.data.data(), sizeof(float),
                       static_cast<size_t>(rf),
                       c->f) != static_cast<size_t>(rf))
          return -1;
        r.freq = it->second.freq;
        r.ts = it->second.ts;
        r.version = s->next_version();
        b.map.emplace(keys[i], std::move(r));
        was_cold = true;
      }
    }
    ColdRecHeader tomb{keys[i], 0, 0, it->second.seq, 0};
    if (!cold_append(c, tomb, nullptr)) return -1;
    if (was_cold) ++moved;
  }
  return moved;
}

// Export live cold rows with seq > since into caller buffers; returns
// the count, or -1 if capacity is too small, -2 on IO error.
int64_t cold_export(void* h, int64_t since, int64_t* keys_out,
                    float* rows_out, int64_t* freq_out, int64_t* ts_out,
                    int64_t capacity) {
  ColdStore* c = static_cast<ColdStore*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  int64_t n = 0;
  for (auto& kv : c->index) {
    if (kv.second.seq <= since) continue;
    if (n >= capacity) return -1;
    if (std::fseek(c->f, static_cast<long>(kv.second.offset),
                   SEEK_SET) != 0)
      return -2;
    if (std::fread(rows_out + n * c->row_floats, sizeof(float),
                   static_cast<size_t>(c->row_floats),
                   c->f) != static_cast<size_t>(c->row_floats))
      return -2;
    keys_out[n] = kv.first;
    freq_out[n] = kv.second.freq;
    ts_out[n] = kv.second.ts;
    ++n;
  }
  return n;
}

// Count of live cold rows with seq > since (delta-export sizing —
// mirrors kv_export_count for the hot tier).
int64_t cold_export_count(void* h, int64_t since) {
  ColdStore* c = static_cast<ColdStore*>(h);
  std::lock_guard<std::mutex> g(c->mu);
  int64_t n = 0;
  for (auto& kv : c->index)
    if (kv.second.seq > since) ++n;
  return n;
}

// Read freq/ts metadata for keys (absent keys: -1).
void kv_meta(void* h, const int64_t* keys, int64_t n, int64_t* freq_out,
             int64_t* ts_out) {
  Store* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    Bucket& b = s->bucket(keys[i]);
    std::lock_guard<std::mutex> g(b.mu);
    auto it = b.map.find(keys[i]);
    if (it == b.map.end()) {
      freq_out[i] = -1;
      ts_out[i] = -1;
    } else {
      freq_out[i] = it->second.freq;
      ts_out[i] = it->second.ts;
    }
  }
}

}  // extern "C"
