// TFRecord framing and the tf.train.Example wire codec of the PyTorch
// port: a small C library loaded with ctypes
// (tensorflowonspark_tpu_torch/recordio/tfrecord_native.py), built at
// first use by recordio/_build.py into build/torch_native/.
//
// The port's own copy of the JAX package's record codec, with its
// memory-buffer reader and writer (tfr_mem_*, tfr_load_columnar_mem:
// the remote-filesystem path, where fsspec moves the bytes and this
// library frames them).  Files and Examples are byte-compatible with
// the JAX package's in both directions.
//
// File format (TFRecord):
//   uint64le length
//   uint32le masked_crc32c(length bytes)
//   byte     data[length]
//   uint32le masked_crc32c(data)
// mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8
//
// The Example protobuf schema is tiny and stable; the encoder/decoder
// below speaks raw proto wire format (varint + length-delimited) so no
// libprotobuf link is needed:
//   Example       { Features features = 1; }
//   Features      { map<string, Feature> feature = 1; }
//   Feature       { oneof { BytesList b = 1; FloatList f = 2; Int64List i = 3; } }
//   BytesList     { repeated bytes value = 1; }
//   FloatList     { repeated float value = 1 [packed]; }
//   Int64List     { repeated int64 value = 1 [packed]; }

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// crc32c (Castagnoli), slicing-by-8
// ---------------------------------------------------------------------------

struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    const uint32_t poly = 0x82f63b78u;  // reflected CRC-32C
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = t[0][i];
      for (int s = 1; s < 8; s++) {
        c = t[0][c & 0xff] ^ (c >> 8);
        t[s][i] = c;
      }
    }
  }
};

// built when the library loads, before any caller's thread can race it
static const CrcTable kCrc;

static uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xffffffffu;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= c;  // little-endian host assumed (x86/arm64)
    c = kCrc.t[7][w & 0xff] ^ kCrc.t[6][(w >> 8) & 0xff] ^
        kCrc.t[5][(w >> 16) & 0xff] ^ kCrc.t[4][(w >> 24) & 0xff] ^
        kCrc.t[3][(w >> 32) & 0xff] ^ kCrc.t[2][(w >> 40) & 0xff] ^
        kCrc.t[1][(w >> 48) & 0xff] ^ kCrc.t[0][(w >> 56) & 0xff];
    p += 8;
    n -= 8;
  }
  while (n--) c = kCrc.t[0][(c ^ *p++) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

static uint32_t masked_crc(const uint8_t* p, size_t n) {
  uint32_t crc = crc32c(p, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

extern "C" {

// ---------------------------------------------------------------------------
// Writer
// ---------------------------------------------------------------------------

struct TFRWriter {
  FILE* f;
};

TFRWriter* tfr_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new TFRWriter{f};
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  return w;
}

int tfr_writer_write(TFRWriter* w, const uint8_t* data, uint64_t len) {
  uint8_t header[12];
  memcpy(header, &len, 8);
  uint32_t lcrc = masked_crc(header, 8);
  memcpy(header + 8, &lcrc, 4);
  if (fwrite(header, 1, 12, w->f) != 12) return -1;
  if (len && fwrite(data, 1, len, w->f) != len) return -1;
  uint32_t dcrc = masked_crc(data, len);
  if (fwrite(&dcrc, 1, 4, w->f) != 4) return -1;
  return 0;
}

int tfr_writer_close(TFRWriter* w) {
  int rc = fclose(w->f);
  delete w;
  return rc;
}

// ---------------------------------------------------------------------------
// Reader
// ---------------------------------------------------------------------------

struct TFRReader {
  FILE* f;
  std::vector<uint8_t> buf;
};

TFRReader* tfr_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new TFRReader{f, {}};
  setvbuf(f, nullptr, _IOFBF, 1 << 20);
  return r;
}

// Returns record length (>= 0, may be 0 for an empty record) and sets
// *out to an internal buffer valid until the next call; -1 at clean EOF;
// < -1 on truncation/corruption.
int64_t tfr_reader_next(TFRReader* r, const uint8_t** out) {
  uint8_t header[12];
  size_t got = fread(header, 1, 12, r->f);
  if (got == 0) return -1;  // clean EOF
  if (got != 12) return -2;
  uint64_t len;
  memcpy(&len, header, 8);
  uint32_t lcrc;
  memcpy(&lcrc, header + 8, 4);
  if (masked_crc(header, 8) != lcrc) return -3;
  if (len > (1ull << 34)) return -4;  // sanity: >16GB record
  r->buf.resize(len);
  if (len && fread(r->buf.data(), 1, len, r->f) != len) return -5;
  uint32_t dcrc;
  if (fread(&dcrc, 1, 4, r->f) != 4) return -6;
  if (masked_crc(r->buf.data(), len) != dcrc) return -7;
  *out = r->buf.data();
  return (int64_t)len;
}

int tfr_reader_close(TFRReader* r) {
  int rc = fclose(r->f);
  delete r;
  return rc;
}

// ---------------------------------------------------------------------------
// Memory-buffer variants: the same framing over bytes the caller owns, so
// Python can move remote objects (gs://, hdfs://, s3://, memory://)
// through fsspec while this library still does the framing and crcs.
// ---------------------------------------------------------------------------

struct TFRMemWriter {
  std::string out;
};

TFRMemWriter* tfr_mem_writer_new() { return new TFRMemWriter(); }

int tfr_mem_writer_write(TFRMemWriter* w, const uint8_t* data, uint64_t len) {
  uint8_t header[12];
  memcpy(header, &len, 8);
  uint32_t lcrc = masked_crc(header, 8);
  memcpy(header + 8, &lcrc, 4);
  w->out.append((const char*)header, 12);
  if (len) w->out.append((const char*)data, len);
  uint32_t dcrc = masked_crc(data, len);
  w->out.append((const char*)&dcrc, 4);
  return 0;
}

// Valid until the next write or free; *n receives the size.
const uint8_t* tfr_mem_writer_data(TFRMemWriter* w, uint64_t* n) {
  *n = w->out.size();
  return (const uint8_t*)w->out.data();
}

void tfr_mem_writer_clear(TFRMemWriter* w) { w->out.clear(); }

void tfr_mem_writer_free(TFRMemWriter* w) { delete w; }

struct TFRMemReader {
  const uint8_t* data;  // caller-owned; must outlive the reader
  uint64_t len;
  uint64_t pos;
};

TFRMemReader* tfr_mem_reader_new(const uint8_t* data, uint64_t len) {
  return new TFRMemReader{data, len, 0};
}

// tfr_reader_next's contract; *out points into the caller's buffer.
int64_t tfr_mem_reader_next(TFRMemReader* r, const uint8_t** out) {
  if (r->pos == r->len) return -1;  // clean EOF
  if (r->len - r->pos < 12) return -2;
  const uint8_t* header = r->data + r->pos;
  uint64_t len;
  memcpy(&len, header, 8);
  uint32_t lcrc;
  memcpy(&lcrc, header + 8, 4);
  if (masked_crc(header, 8) != lcrc) return -3;
  if (len > (1ull << 34)) return -4;
  if (r->len - r->pos - 12 < len + 4) return -5;
  const uint8_t* body = header + 12;
  uint32_t dcrc;
  memcpy(&dcrc, body + len, 4);
  if (masked_crc(body, len) != dcrc) return -7;
  r->pos += 12 + len + 4;
  *out = body;
  return (int64_t)len;
}

void tfr_mem_reader_free(TFRMemReader* r) { delete r; }

// ---------------------------------------------------------------------------
// Proto wire helpers
// ---------------------------------------------------------------------------

static void put_varint(std::string& s, uint64_t v) {
  while (v >= 0x80) {
    s.push_back((char)((v & 0x7f) | 0x80));
    v >>= 7;
  }
  s.push_back((char)v);
}

static bool get_varint(const uint8_t*& p, const uint8_t* end, uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    r |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return true;
    }
    shift += 7;
  }
  return false;
}

static void put_tag(std::string& s, int field, int wire) {
  put_varint(s, (uint64_t)(field << 3 | wire));
}

static void put_len_delim(std::string& s, int field, const std::string& payload) {
  put_tag(s, field, 2);
  put_varint(s, payload.size());
  s.append(payload);
}

// ---------------------------------------------------------------------------
// Example encoder
//
// The exb_* API assembles one Example from typed feature columns.
// ---------------------------------------------------------------------------

struct ExampleEncoder {
  std::string features;  // serialized map entries
};

ExampleEncoder* exb_new() { return new ExampleEncoder(); }
void exb_free(ExampleEncoder* b) { delete b; }

static void exb_add_entry(ExampleEncoder* b, const char* name,
                          const std::string& feature) {
  std::string entry;
  std::string key(name);
  put_tag(entry, 1, 2);
  put_varint(entry, key.size());
  entry.append(key);
  put_len_delim(entry, 2, feature);
  put_len_delim(b->features, 1, entry);
}

void exb_add_int64(ExampleEncoder* b, const char* name, const int64_t* vals,
                   int n) {
  std::string packed;
  for (int i = 0; i < n; i++) put_varint(packed, (uint64_t)vals[i]);
  std::string list;
  put_len_delim(list, 1, packed);
  std::string feature;
  put_len_delim(feature, 3, list);  // Feature.int64_list = 3
  exb_add_entry(b, name, feature);
}

void exb_add_float(ExampleEncoder* b, const char* name, const float* vals,
                   int n) {
  std::string packed((const char*)vals, (size_t)n * 4);
  std::string list;
  put_len_delim(list, 1, packed);
  std::string feature;
  put_len_delim(feature, 2, list);  // Feature.float_list = 2
  exb_add_entry(b, name, feature);
}

void exb_add_bytes(ExampleEncoder* b, const char* name, const uint8_t** vals,
                   const uint64_t* lens, int n) {
  std::string list;
  for (int i = 0; i < n; i++) {
    std::string v((const char*)vals[i], lens[i]);
    put_len_delim(list, 1, v);
  }
  std::string feature;
  put_len_delim(feature, 1, list);  // Feature.bytes_list = 1
  exb_add_entry(b, name, feature);
}

// Serialize Example into caller-readable buffer (valid until next call/free).
const uint8_t* exb_serialize(ExampleEncoder* b, uint64_t* out_len) {
  static thread_local std::string out;
  out.clear();
  put_len_delim(out, 1, b->features);  // Example.features = 1
  *out_len = out.size();
  b->features.clear();
  return (const uint8_t*)out.data();
}

// ---------------------------------------------------------------------------
// Example decoder: parses a serialized Example into a flat feature table
// the Python side walks via accessors.
// ---------------------------------------------------------------------------

struct DecodedFeature {
  std::string name;
  int kind;  // 1=bytes 2=float 3=int64
  std::vector<std::string> bytes_vals;
  std::vector<float> float_vals;
  std::vector<int64_t> int64_vals;
};

struct ExampleDecoder {
  std::vector<DecodedFeature> feats;
};

static bool parse_feature(const uint8_t* p, const uint8_t* end,
                          DecodedFeature* f) {
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3);
    uint64_t len;
    if (!get_varint(p, end, &len)) return false;
    if (len > (uint64_t)(end - p)) return false;
    const uint8_t* lend = p + len;
    // field ∈ {1,2,3} → the list message; inside: field 1 = values
    f->kind = field;
    const uint8_t* q = p;
    while (q < lend) {
      uint64_t vtag;
      if (!get_varint(q, lend, &vtag)) return false;
      int vfield = (int)(vtag >> 3);
      int vwire = (int)(vtag & 7);
      if (vfield != 1) return false;
      if (field == 1) {  // bytes values, wire 2
        uint64_t blen;
        if (!get_varint(q, lend, &blen)) return false;
        if (blen > (uint64_t)(lend - q)) return false;
        f->bytes_vals.emplace_back((const char*)q, blen);
        q += blen;
      } else if (field == 2) {  // floats: packed (wire 2) or single (wire 5)
        if (vwire == 2) {
          uint64_t blen;
          if (!get_varint(q, lend, &blen)) return false;
          if (blen > (uint64_t)(lend - q) || blen % 4) return false;
          size_t cnt = blen / 4;
          size_t base = f->float_vals.size();
          f->float_vals.resize(base + cnt);
          memcpy(f->float_vals.data() + base, q, blen);
          q += blen;
        } else if (vwire == 5) {
          if (q + 4 > lend) return false;
          float v;
          memcpy(&v, q, 4);
          f->float_vals.push_back(v);
          q += 4;
        } else {
          return false;
        }
      } else if (field == 3) {  // int64: packed or single varints
        if (vwire == 2) {
          uint64_t blen;
          if (!get_varint(q, lend, &blen)) return false;
          if (blen > (uint64_t)(lend - q)) return false;
          const uint8_t* vend = q + blen;
          while (q < vend) {
            uint64_t v;
            if (!get_varint(q, vend, &v)) return false;
            f->int64_vals.push_back((int64_t)v);
          }
        } else if (vwire == 0) {
          uint64_t v;
          if (!get_varint(q, lend, &v)) return false;
          f->int64_vals.push_back((int64_t)v);
        } else {
          return false;
        }
      } else {
        return false;
      }
    }
    p = lend;
  }
  return true;
}

ExampleDecoder* exd_parse(const uint8_t* data, uint64_t len) {
  auto* d = new ExampleDecoder();
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) goto fail;
    {
      int field = (int)(tag >> 3);
      int wire = (int)(tag & 7);
      if (wire != 2) goto fail;
      uint64_t len2;
      if (!get_varint(p, end, &len2)) goto fail;
      if (len2 > (uint64_t)(end - p)) goto fail;
      const uint8_t* fend = p + len2;
      if (field == 1) {  // Features
        const uint8_t* q = p;
        while (q < fend) {
          uint64_t etag;
          if (!get_varint(q, fend, &etag)) goto fail;
          if ((etag & 7) != 2 || (etag >> 3) != 1) goto fail;
          uint64_t elen;
          if (!get_varint(q, fend, &elen)) goto fail;
          if (elen > (uint64_t)(fend - q)) goto fail;
          const uint8_t* eend = q + elen;
          DecodedFeature feat;
          feat.kind = 0;
          // map entry: key=1 (string), value=2 (Feature)
          const uint8_t* m = q;
          while (m < eend) {
            uint64_t mtag;
            if (!get_varint(m, eend, &mtag)) goto fail;
            uint64_t mlen;
            if (!get_varint(m, eend, &mlen)) goto fail;
            if (mlen > (uint64_t)(eend - m)) goto fail;
            if ((mtag >> 3) == 1) {
              feat.name.assign((const char*)m, mlen);
            } else if ((mtag >> 3) == 2) {
              if (!parse_feature(m, m + mlen, &feat)) goto fail;
            }
            m += mlen;
          }
          d->feats.push_back(std::move(feat));
          q = eend;
        }
      }
      p = fend;
    }
  }
  return d;
fail:
  delete d;
  return nullptr;
}

void exd_free(ExampleDecoder* d) { delete d; }

int exd_num_features(ExampleDecoder* d) { return (int)d->feats.size(); }

const char* exd_name(ExampleDecoder* d, int i) {
  return d->feats[i].name.c_str();
}

int exd_kind(ExampleDecoder* d, int i) { return d->feats[i].kind; }

int64_t exd_value_count(ExampleDecoder* d, int i) {
  auto& f = d->feats[i];
  switch (f.kind) {
    case 1: return (int64_t)f.bytes_vals.size();
    case 2: return (int64_t)f.float_vals.size();
    case 3: return (int64_t)f.int64_vals.size();
  }
  return 0;
}

const float* exd_floats(ExampleDecoder* d, int i) {
  return d->feats[i].float_vals.data();
}

const int64_t* exd_int64s(ExampleDecoder* d, int i) {
  return d->feats[i].int64_vals.data();
}

const uint8_t* exd_bytes(ExampleDecoder* d, int i, int j, uint64_t* len) {
  auto& v = d->feats[i].bytes_vals[j];
  *len = v.size();
  return (const uint8_t*)v.data();
}

// ---------------------------------------------------------------------------
// Columnar batch loader: read an entire TFRecord stream and decode every
// Example straight into dense per-feature columns in one C pass — the
// bulk-load analogue of the reference's Hadoop TFRecordFileInputFormat +
// per-row DFUtil.fromTFExample (DFUtil.scala:119-184), shaped for numpy:
// no per-value Python objects, one buffer per feature.
//
// Schema is taken from the first record (names, kinds, value counts);
// every later record must match it exactly.  A mismatch (ragged widths,
// missing/extra features, kind drift) sets an error and the Python side
// falls back to per-row decoding.
// ---------------------------------------------------------------------------

struct ColumnarBatch {
  std::vector<std::string> names;
  std::vector<int> kinds;       // 1=bytes 2=float 3=int64
  std::vector<int64_t> widths;  // values per record per feature
  int64_t nrows = 0;
  std::vector<std::vector<float>> fcols;
  std::vector<std::vector<int64_t>> icols;
  std::vector<std::string> bblobs;            // bytes columns: packed blob
  std::vector<std::vector<uint64_t>> boffs;   // and offsets (count*width+1)
  std::string error;
};

// Parse one Feature submessage, appending values into column slot `c`.
// Returns the number of values appended, or -1 on malformed input.
static int64_t parse_feature_into(ColumnarBatch* cb, int c, int* kind,
                                  const uint8_t* p, const uint8_t* end) {
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return -1;
    int field = (int)(tag >> 3);
    uint64_t len;
    if (!get_varint(p, end, &len)) return -1;
    if (len > (uint64_t)(end - p)) return -1;
    const uint8_t* lend = p + len;
    if (*kind != 0 && *kind != field) return -1;  // mixed-kind Feature
    *kind = field;
    const uint8_t* q = p;
    while (q < lend) {
      uint64_t vtag;
      if (!get_varint(q, lend, &vtag)) return -1;
      if ((int)(vtag >> 3) != 1) return -1;
      int vwire = (int)(vtag & 7);
      if (field == 1) {  // bytes
        uint64_t blen;
        if (vwire != 2 || !get_varint(q, lend, &blen)) return -1;
        if (blen > (uint64_t)(lend - q)) return -1;
        cb->bblobs[c].append((const char*)q, blen);
        cb->boffs[c].push_back(cb->bblobs[c].size());
        q += blen;
        count++;
      } else if (field == 2) {  // float: packed or single fixed32
        if (vwire == 2) {
          uint64_t blen;
          if (!get_varint(q, lend, &blen)) return -1;
          if (blen > (uint64_t)(lend - q) || blen % 4) return -1;
          size_t cnt = blen / 4;
          auto& col = cb->fcols[c];
          size_t base = col.size();
          col.resize(base + cnt);
          memcpy(col.data() + base, q, blen);
          q += blen;
          count += (int64_t)cnt;
        } else if (vwire == 5) {
          if (q + 4 > lend) return -1;
          float v;
          memcpy(&v, q, 4);
          cb->fcols[c].push_back(v);
          q += 4;
          count++;
        } else {
          return -1;
        }
      } else if (field == 3) {  // int64: packed or single varint
        if (vwire == 2) {
          uint64_t blen;
          if (!get_varint(q, lend, &blen)) return -1;
          if (blen > (uint64_t)(lend - q)) return -1;
          const uint8_t* vend = q + blen;
          while (q < vend) {
            uint64_t v;
            if (!get_varint(q, vend, &v)) return -1;
            cb->icols[c].push_back((int64_t)v);
            count++;
          }
        } else if (vwire == 0) {
          uint64_t v;
          if (!get_varint(q, lend, &v)) return -1;
          cb->icols[c].push_back((int64_t)v);
          count++;
        } else {
          return -1;
        }
      } else {
        return -1;
      }
    }
    p = lend;
  }
  return count;
}

static int colb_index_of(ColumnarBatch* cb, const char* name, size_t len) {
  for (size_t i = 0; i < cb->names.size(); i++)
    if (cb->names[i].size() == len && !memcmp(cb->names[i].data(), name, len))
      return (int)i;
  return -1;
}

// Decode one Example record into the batch; grows the schema on row 0.
static bool colb_add_record(ColumnarBatch* cb, const uint8_t* data,
                            uint64_t len) {
  bool first = (cb->nrows == 0);
  std::vector<uint8_t> seen(cb->names.size(), 0);
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    if ((tag & 7) != 2) return false;
    uint64_t len2;
    if (!get_varint(p, end, &len2)) return false;
    if (len2 > (uint64_t)(end - p)) return false;
    const uint8_t* fend = p + len2;
    if ((int)(tag >> 3) == 1) {  // Features
      const uint8_t* q = p;
      while (q < fend) {
        uint64_t etag;
        if (!get_varint(q, fend, &etag)) return false;
        if ((etag & 7) != 2 || (etag >> 3) != 1) return false;
        uint64_t elen;
        if (!get_varint(q, fend, &elen)) return false;
        if (elen > (uint64_t)(fend - q)) return false;
        const uint8_t* eend = q + elen;
        // map entry: key=1 (string), value=2 (Feature)
        const char* kname = nullptr;
        size_t klen = 0;
        const uint8_t* fmsg = nullptr;
        uint64_t fmlen = 0;
        const uint8_t* m = q;
        while (m < eend) {
          uint64_t mtag;
          if (!get_varint(m, eend, &mtag)) return false;
          uint64_t mlen;
          if (!get_varint(m, eend, &mlen)) return false;
          if (mlen > (uint64_t)(eend - m)) return false;
          if ((mtag >> 3) == 1) {
            kname = (const char*)m;
            klen = mlen;
          } else if ((mtag >> 3) == 2) {
            fmsg = m;
            fmlen = mlen;
          }
          m += mlen;
        }
        if (!kname || !fmsg) return false;
        int c = colb_index_of(cb, kname, klen);
        if (c < 0) {
          if (!first) {
            cb->error = "feature '" + std::string(kname, klen) +
                        "' absent from the first record";
            return false;
          }
          c = (int)cb->names.size();
          cb->names.emplace_back(kname, klen);
          cb->kinds.push_back(0);
          cb->widths.push_back(-1);
          cb->fcols.emplace_back();
          cb->icols.emplace_back();
          cb->bblobs.emplace_back();
          cb->boffs.emplace_back(1, 0);
          seen.push_back(0);
        }
        // a repeated key would append a second run of values to the same
        // column and shift every later row — corrupt, not mergeable
        if (seen[c]) {
          cb->error = "feature '" + cb->names[c] + "' repeated in a record";
          return false;
        }
        seen[c] = 1;
        int kind = 0;
        int64_t cnt = parse_feature_into(cb, c, &kind, fmsg, fmsg + fmlen);
        if (cnt < 0) return false;
        if (first) {
          cb->kinds[c] = kind;
          cb->widths[c] = cnt;
        } else if (cb->kinds[c] != kind) {
          cb->error = "feature '" + cb->names[c] + "' changed kind";
          return false;
        } else if (cb->widths[c] != cnt) {
          cb->error = "feature '" + cb->names[c] + "' is ragged";
          return false;
        }
        q = eend;
      }
    }
    p = fend;
  }
  if (!first)
    for (size_t i = 0; i < seen.size(); i++)
      if (!seen[i]) {
        cb->error = "feature '" + cb->names[i] + "' missing from a record";
        return false;
      }
  cb->nrows++;
  return true;
}

ColumnarBatch* tfr_load_columnar_mem(const uint8_t* data, uint64_t len) {
  auto* cb = new ColumnarBatch();
  TFRMemReader r{data, len, 0};
  const uint8_t* rec;
  int64_t rlen;
  while ((rlen = tfr_mem_reader_next(&r, &rec)) >= 0) {
    if (!colb_add_record(cb, rec, (uint64_t)rlen)) {
      if (cb->error.empty()) cb->error = "unparseable tf.train.Example";
      return cb;
    }
  }
  if (rlen < -1) cb->error = "corrupt TFRecord framing";
  return cb;
}

ColumnarBatch* tfr_load_columnar(const char* path) {
  auto* cb = new ColumnarBatch();
  TFRReader* r = tfr_reader_open(path);
  if (!r) {
    cb->error = "cannot open file";
    return cb;
  }
  const uint8_t* rec;
  int64_t rlen;
  while ((rlen = tfr_reader_next(r, &rec)) >= 0) {
    if (!colb_add_record(cb, rec, (uint64_t)rlen)) {
      if (cb->error.empty()) cb->error = "unparseable tf.train.Example";
      break;
    }
  }
  if (rlen < -1) cb->error = "corrupt TFRecord framing";
  tfr_reader_close(r);
  return cb;
}

int colb_ok(ColumnarBatch* cb) { return cb->error.empty() ? 1 : 0; }
const char* colb_error(ColumnarBatch* cb) { return cb->error.c_str(); }
int64_t colb_num_rows(ColumnarBatch* cb) { return cb->nrows; }
int colb_num_features(ColumnarBatch* cb) { return (int)cb->names.size(); }
const char* colb_name(ColumnarBatch* cb, int i) { return cb->names[i].c_str(); }
int colb_kind(ColumnarBatch* cb, int i) { return cb->kinds[i]; }
int64_t colb_width(ColumnarBatch* cb, int i) { return cb->widths[i]; }
const float* colb_floats(ColumnarBatch* cb, int i) {
  return cb->fcols[i].data();
}
const int64_t* colb_int64s(ColumnarBatch* cb, int i) {
  return cb->icols[i].data();
}
const uint8_t* colb_bytes_blob(ColumnarBatch* cb, int i) {
  return (const uint8_t*)cb->bblobs[i].data();
}
const uint64_t* colb_bytes_offsets(ColumnarBatch* cb, int i) {
  return cb->boffs[i].data();
}
void colb_free(ColumnarBatch* cb) { delete cb; }

// crc utility exposed for tests
uint32_t tfr_crc32c(const uint8_t* p, uint64_t n) { return crc32c(p, n); }

}  // extern "C"
