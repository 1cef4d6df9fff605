// PTRecordIO — the chunked record file format of the reader pipeline;
// the port's copy of the JAX package's codec, byte for byte the same
// format, so a shard written by either package reads in the other.
//
// Layout (little-endian, all u32):
//   file  := chunk*
//   chunk := magic(0x50545243 "PTRC") | num_records | payload_len | crc32
//            | payload
//   payload := (rec_len | rec_bytes)*
//
// crc32 covers the payload. Writers emit whole chunks; readers validate
// the crc before handing out records, and can seek straight to chunk k.
// A pure-Python twin lives in paddle_tpu_torch/reader/recordio.py (same
// byte layout).
//
// Build: g++ -O2 -shared -fPIC -o libptrecordio.so recordio.cc
// (plain C ABI; reader/recordio.py builds it into build/paddle_tpu_torch/
// at first use).

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

extern "C" {

static const uint32_t kMagic = 0x50545243u;  // "PTRC"

// crc32 (IEEE, bit-reflected), table computed on first use
static uint32_t crc_table[256];
static int crc_ready = 0;

static void crc_init(void) {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
    crc_table[i] = c;
  }
  crc_ready = 1;
}

static uint32_t crc32_of(const uint8_t* buf, size_t len) {
  if (!crc_ready) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- writer

typedef struct {
  FILE* f;
  uint8_t* buf;        // pending payload
  size_t len, cap;
  uint32_t n_records;
  uint32_t max_chunk;  // flush threshold (payload bytes)
} pt_writer;

pt_writer* pt_writer_open(const char* path, uint32_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return NULL;
  pt_writer* w = (pt_writer*)calloc(1, sizeof(pt_writer));
  w->f = f;
  w->cap = 1 << 16;
  w->buf = (uint8_t*)malloc(w->cap);
  w->max_chunk = max_chunk_bytes ? max_chunk_bytes : (1u << 20);
  return w;
}

int pt_writer_flush(pt_writer* w) {
  if (!w || !w->f) return -1;
  if (w->n_records == 0) return 0;
  uint32_t hdr[4] = {kMagic, w->n_records, (uint32_t)w->len,
                     crc32_of(w->buf, w->len)};
  if (fwrite(hdr, sizeof(hdr), 1, w->f) != 1) return -1;
  if (w->len && fwrite(w->buf, 1, w->len, w->f) != w->len) return -1;
  w->len = 0;
  w->n_records = 0;
  return 0;
}

int pt_writer_write(pt_writer* w, const uint8_t* data, uint32_t size) {
  if (!w) return -1;
  size_t need = w->len + 4 + size;
  if (need > w->cap) {
    while (w->cap < need) w->cap *= 2;
    w->buf = (uint8_t*)realloc(w->buf, w->cap);
  }
  memcpy(w->buf + w->len, &size, 4);
  memcpy(w->buf + w->len + 4, data, size);
  w->len += 4 + size;
  w->n_records += 1;
  if (w->len >= w->max_chunk) return pt_writer_flush(w);
  return 0;
}

int pt_writer_close(pt_writer* w) {
  if (!w) return -1;
  int rc = pt_writer_flush(w);
  fclose(w->f);
  free(w->buf);
  free(w);
  return rc;
}

// ---------------------------------------------------------------- reader

typedef struct {
  FILE* f;
  long* chunk_off;     // file offset of each chunk header
  uint32_t* chunk_n;   // records per chunk
  uint32_t n_chunks;
  // current chunk payload
  uint8_t* payload;
  size_t payload_len;
  size_t cursor;       // byte cursor in payload
} pt_reader;

pt_reader* pt_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  pt_reader* r = (pt_reader*)calloc(1, sizeof(pt_reader));
  r->f = f;
  long fsize = -1;
  if (fseek(f, 0, SEEK_END) == 0) fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  // index pass: walk chunk headers
  uint32_t cap = 16;
  r->chunk_off = (long*)malloc(cap * sizeof(long));
  r->chunk_n = (uint32_t*)malloc(cap * sizeof(uint32_t));
  for (;;) {
    long off = ftell(f);
    uint32_t hdr[4];
    if (fread(hdr, sizeof(hdr), 1, f) != 1) break;
    // torn/truncated tail (crash mid-append, partial copy): the shard
    // ends here — index the intact prefix instead of failing the open,
    // matching _py_index in reader/recordio.py
    if (hdr[0] != kMagic) break;
    if (fsize >= 0 && off + (long)sizeof(hdr) + (long)hdr[2] > fsize)
      break;  // header intact but payload runs past EOF: torn tail
    if (r->n_chunks == cap) {
      cap *= 2;
      r->chunk_off = (long*)realloc(r->chunk_off, cap * sizeof(long));
      r->chunk_n = (uint32_t*)realloc(r->chunk_n, cap * sizeof(uint32_t));
    }
    r->chunk_off[r->n_chunks] = off;
    r->chunk_n[r->n_chunks] = hdr[1];
    r->n_chunks += 1;
    if (fseek(f, (long)hdr[2], SEEK_CUR) != 0) break;
  }
  return r;
}

uint32_t pt_reader_num_chunks(pt_reader* r) { return r ? r->n_chunks : 0; }

uint32_t pt_reader_chunk_records(pt_reader* r, uint32_t k) {
  return (r && k < r->n_chunks) ? r->chunk_n[k] : 0;
}

// position the reader at chunk k; validates crc. Returns 0 on success.
int pt_reader_seek_chunk(pt_reader* r, uint32_t k) {
  if (!r || k >= r->n_chunks) return -1;
  if (fseek(r->f, r->chunk_off[k], SEEK_SET) != 0) return -1;
  uint32_t hdr[4];
  if (fread(hdr, sizeof(hdr), 1, r->f) != 1) return -1;
  if (hdr[0] != kMagic) return -1;
  if (hdr[2] > r->payload_len || !r->payload) {
    r->payload = (uint8_t*)realloc(r->payload, hdr[2] ? hdr[2] : 1);
  }
  r->payload_len = hdr[2];
  if (hdr[2] && fread(r->payload, 1, hdr[2], r->f) != hdr[2]) return -1;
  if (crc32_of(r->payload, r->payload_len) != hdr[3]) return -2;  // corrupt
  r->cursor = 0;
  return 0;
}

// next record in the current chunk: returns length, fills *out with a
// pointer INTO the reader's buffer (valid until the next seek); -1 = end
int64_t pt_reader_next(pt_reader* r, const uint8_t** out) {
  if (!r || r->cursor + 4 > r->payload_len) return -1;
  uint32_t len;
  memcpy(&len, r->payload + r->cursor, 4);
  if (r->cursor + 4 + len > r->payload_len) return -1;
  *out = r->payload + r->cursor + 4;
  r->cursor += 4 + len;
  return (int64_t)len;
}

void pt_reader_close(pt_reader* r) {
  if (!r) return;
  fclose(r->f);
  free(r->chunk_off);
  free(r->chunk_n);
  free(r->payload);
  free(r);
}

}  // extern "C"
