// Fast PCD parser: the native data-loader component.
//
// The reference leans on open3d (C++) for .pcd IO (reference:
// opencood/utils/pcd_utils.py:9-33); here a minimal dependency-free C++
// parser feeds the host input pipeline: header parse, ascii (strtof loop)
// or binary (strided copy) decode of x/y/z + intensity (direct field or
// packed-rgb red channel), optional Fisher-Yates shuffle, truncation to
// max_points. Exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -o libpcd_parser.so pcd_parser.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Field {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
  int offset = 0;  // byte offset within a binary record
};

struct Header {
  std::vector<Field> fields;
  long points = 0;
  bool binary = false;
  int record_size = 0;
  long data_start = 0;
};

bool parse_header(FILE* f, Header* h) {
  char line[4096];
  int offset = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '#') continue;
    char key[64];
    if (sscanf(line, "%63s", key) != 1) continue;
    std::string k(key);
    const char* rest = line + k.size();
    if (k == "FIELDS") {
      char name[64];
      int consumed;
      while (sscanf(rest, "%63s%n", name, &consumed) == 1) {
        Field fld;
        fld.name = name;
        h->fields.push_back(fld);
        rest += consumed;
      }
    } else if (k == "SIZE" || k == "COUNT" || k == "TYPE") {
      size_t i = 0;
      if (k == "TYPE") {
        char t[8];
        int consumed;
        while (i < h->fields.size() &&
               sscanf(rest, "%7s%n", t, &consumed) == 1) {
          h->fields[i++].type = t[0];
          rest += consumed;
        }
      } else {
        int v, consumed;
        while (i < h->fields.size() &&
               sscanf(rest, "%d%n", &v, &consumed) == 1) {
          if (k == "SIZE") h->fields[i].size = v;
          else h->fields[i].count = v;
          ++i;
          rest += consumed;
        }
      }
    } else if (k == "POINTS") {
      sscanf(rest, "%ld", &h->points);
    } else if (k == "DATA") {
      char mode[32];
      sscanf(rest, "%31s", mode);
      h->binary = (strcmp(mode, "binary") == 0);
      h->data_start = ftell(f);
      for (auto& fld : h->fields) {
        fld.offset = offset;
        offset += fld.size * fld.count;
      }
      h->record_size = offset;
      return true;
    }
  }
  return false;
}

float read_scalar(const char* p, const Field& f) {
  switch (f.type) {
    case 'F':
      if (f.size == 4) { float v; memcpy(&v, p, 4); return v; }
      else { double v; memcpy(&v, p, 8); return (float)v; }
    case 'U':
      if (f.size == 1) return (float)*(const uint8_t*)p;
      if (f.size == 2) { uint16_t v; memcpy(&v, p, 2); return (float)v; }
      { uint32_t v; memcpy(&v, p, 4); return (float)v; }
    case 'I':
      if (f.size == 1) return (float)*(const int8_t*)p;
      if (f.size == 2) { int16_t v; memcpy(&v, p, 2); return (float)v; }
      { int32_t v; memcpy(&v, p, 4); return (float)v; }
  }
  return 0.0f;
}

float rgb_red(const char* p, const Field& f) {
  uint32_t packed = 0;
  if (f.type == 'F' && f.size == 4) {
    memcpy(&packed, p, 4);  // float bits hold the packed int
  } else {
    memcpy(&packed, p, f.size < 4 ? f.size : 4);
  }
  return (float)((packed >> 16) & 0xFF) / 255.0f;
}

}  // namespace

extern "C" {

// Parse `path` into out[max_points * 4] as x,y,z,intensity rows.
// shuffle != 0 applies a seeded Fisher-Yates permutation before
// truncating to max_points (so truncation keeps a random subset).
// Returns the number of rows written, or -1 on error.
long parse_pcd(const char* path, float* out, long max_points,
               unsigned seed, int shuffle) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!parse_header(f, &h) || h.points <= 0) {
    fclose(f);
    return -1;
  }

  int ix = -1, iy = -1, iz = -1, ii = -1, irgb = -1;
  for (size_t i = 0; i < h.fields.size(); ++i) {
    const std::string& n = h.fields[i].name;
    if (n == "x") ix = (int)i;
    else if (n == "y") iy = (int)i;
    else if (n == "z") iz = (int)i;
    else if (n == "intensity") ii = (int)i;
    else if (n == "rgb") irgb = (int)i;
  }
  if (ix < 0 || iy < 0 || iz < 0) {
    fclose(f);
    return -1;
  }

  std::vector<float> all((size_t)h.points * 4, 0.0f);
  long n_read = 0;

  if (h.binary) {
    std::vector<char> buf((size_t)h.points * h.record_size);
    size_t got = fread(buf.data(), 1, buf.size(), f);
    long n = (long)(got / h.record_size);
    for (long i = 0; i < n; ++i) {
      const char* rec = buf.data() + (size_t)i * h.record_size;
      all[i * 4 + 0] = read_scalar(rec + h.fields[ix].offset, h.fields[ix]);
      all[i * 4 + 1] = read_scalar(rec + h.fields[iy].offset, h.fields[iy]);
      all[i * 4 + 2] = read_scalar(rec + h.fields[iz].offset, h.fields[iz]);
      if (ii >= 0)
        all[i * 4 + 3] =
            read_scalar(rec + h.fields[ii].offset, h.fields[ii]);
      else if (irgb >= 0)
        all[i * 4 + 3] = rgb_red(rec + h.fields[irgb].offset,
                                 h.fields[irgb]);
    }
    n_read = n;
  } else {
    // ascii: token-wise strtof walk; column positions from field layout
    std::vector<int> col_of_field(h.fields.size());
    int ncols = 0;
    for (size_t i = 0; i < h.fields.size(); ++i) {
      col_of_field[i] = ncols;
      ncols += h.fields[i].count;
    }
    std::vector<double> row((size_t)ncols);
    char line[16384];
    long i = 0;
    while (i < h.points && fgets(line, sizeof(line), f)) {
      char* p = line;
      bool ok = true;
      for (int c = 0; c < ncols; ++c) {
        char* end;
        row[c] = strtod(p, &end);
        if (end == p) { ok = false; break; }
        p = end;
      }
      if (!ok) continue;
      all[i * 4 + 0] = (float)row[col_of_field[ix]];
      all[i * 4 + 1] = (float)row[col_of_field[iy]];
      all[i * 4 + 2] = (float)row[col_of_field[iz]];
      if (ii >= 0) all[i * 4 + 3] = (float)row[col_of_field[ii]];
      else if (irgb >= 0) {
        float fv = (float)row[col_of_field[irgb]];
        uint32_t packed;
        memcpy(&packed, &fv, 4);
        all[i * 4 + 3] = (float)((packed >> 16) & 0xFF) / 255.0f;
      }
      ++i;
    }
    n_read = i;
  }
  fclose(f);

  if (shuffle && n_read > 1) {
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
    for (long i = n_read - 1; i > 0; --i) {
      // xorshift64*
      s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
      long j = (long)((s * 0x2545F4914F6CDD1Dull >> 33) % (uint64_t)(i + 1));
      for (int k = 0; k < 4; ++k) {
        float tmp = all[i * 4 + k];
        all[i * 4 + k] = all[j * 4 + k];
        all[j * 4 + k] = tmp;
      }
    }
  }

  long n_out = n_read < max_points ? n_read : max_points;
  memcpy(out, all.data(), (size_t)n_out * 4 * sizeof(float));
  return n_out;
}

}  // extern "C"
