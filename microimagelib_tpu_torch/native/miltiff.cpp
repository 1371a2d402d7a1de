// miltiff — native TIFF stack codec for the batch-pipeline hot path.
//
// The reference links libtiff and decodes scanline-by-scanline on one
// thread (reference:src/apifunc.cpp:140-239). This extension decodes /
// encodes whole pages in parallel with std::thread and fuses the
// u16 <-> f32 conversions into the copy pass, so host TIFF streaming can
// keep up with device compute in the time-lapse batch driver.
//
// Scope: classic + BigTIFF, little-endian, uncompressed, 1 sample/pixel,
// 16-bit unsigned or 32-bit float. Anything else raises so the caller
// falls back to the pure-Python codec (io/tiff.py), and so does a file
// that is truncated or corrupt: every read of the header, the IFDs, the
// tag data and the pages is bounded by the file's size (the JAX package's
// copy of this codec reads past the end of such a file).
//
// Built with the raw CPython C API (no pybind11 in this environment).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Page {
  uint64_t data_off;
  uint64_t nbytes;
};

struct TiffInfo {
  uint32_t width = 0;
  uint32_t height = 0;
  uint16_t bits = 0;
  uint16_t sample_format = 1;
  std::vector<Page> pages;
};

// Every read is bounds-checked: a read past the end of the file, or of a
// length that overflows, fails and sets `bad`, and the parse stops.
struct Reader {
  const uint8_t* p;
  size_t n;

  bool has(uint64_t off, uint64_t len) const { return off <= n && len <= n - off; }

  template <typename T>
  bool at(uint64_t off, T* v) const {
    if (!has(off, sizeof(T))) return false;
    std::memcpy(v, p + off, sizeof(T));  // little-endian host assumed (x86/ARM LE)
    return true;
  }
};

uint64_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    default: return 8;
  }
}

// Parses the IFD chain into `info`. Returns false, with the reason in
// `err`, for a layout this codec does not decode and for any file whose
// IFDs, tag data or page data do not lie inside its bytes, whose strip
// byte count is less than its page, or whose IFD chain returns to an IFD
// it has seen: the caller then hands the file to the NumPy codec.
bool parse_tiff(const Reader& r, TiffInfo* info, std::string* err) {
  if (r.n < 8 || r.p[0] != 'I' || r.p[1] != 'I') {
    *err = "not a little-endian TIFF";
    return false;
  }
  auto truncated = [&](const char* what) {
    *err = std::string("truncated or corrupt TIFF: ") + what + " past the end of the file";
    return false;
  };
  uint16_t version = 0;
  r.at<uint16_t>(2, &version);
  uint64_t ifd_off;
  bool big = false;
  if (version == 42) {
    uint32_t o32 = 0;
    r.at<uint32_t>(4, &o32);
    ifd_off = o32;
  } else if (version == 43) {
    big = true;
    if (!r.at<uint64_t>(8, &ifd_off)) return truncated("BigTIFF header");
  } else {
    *err = "unsupported TIFF version";
    return false;
  }
  const uint64_t entry_sz = big ? 20 : 12;
  const uint64_t ptr_sz = big ? 8 : 4;
  std::set<uint64_t> seen;
  bool first = true;
  while (ifd_off != 0) {
    if (!seen.insert(ifd_off).second) {
      *err = "the IFD chain loops";
      return false;
    }
    uint64_t count = 0;
    if (big) {
      if (!r.at<uint64_t>(ifd_off, &count)) return truncated("IFD");
    } else {
      uint16_t c16 = 0;
      if (!r.at<uint16_t>(ifd_off, &c16)) return truncated("IFD");
      count = c16;
    }
    const uint64_t entry0 = ifd_off + (big ? 8 : 2);
    if (count > r.n / entry_sz || !r.has(entry0, count * entry_sz + ptr_sz))
      return truncated("IFD entries");
    uint32_t width = 0, height = 0;
    uint16_t bits = 1, comp = 1, spp = 1, sfmt = 1;
    bool imagej_contig = false;
    std::vector<uint64_t> strip_offs, strip_counts;
    for (uint64_t i = 0; i < count; ++i) {
      const uint64_t e = entry0 + i * entry_sz;  // inside the file: checked above
      uint16_t tag = 0, typ = 0;
      r.at<uint16_t>(e, &tag);
      r.at<uint16_t>(e + 2, &typ);
      uint64_t n = 0;
      if (big) {
        r.at<uint64_t>(e + 4, &n);
      } else {
        uint32_t n32 = 0;
        r.at<uint32_t>(e + 4, &n32);
        n = n32;
      }
      const uint64_t vpos = e + (big ? 12 : 8);
      const uint64_t tsz = type_size(typ);
      if (n > r.n) return truncated("tag data");  // more values than the file has bytes
      const uint64_t total = tsz * n;
      uint64_t data_pos = vpos;
      if (total > ptr_sz) {
        if (big) {
          r.at<uint64_t>(vpos, &data_pos);
        } else {
          uint32_t d32 = 0;
          r.at<uint32_t>(vpos, &d32);
          data_pos = d32;
        }
      }
      bool ok = true;
      auto read_val = [&](uint64_t idx) -> uint64_t {
        const uint64_t off = data_pos + idx * tsz;
        switch (typ) {
          case 3: { uint16_t v = 0; ok = ok && r.at<uint16_t>(off, &v); return v; }
          case 16: { uint64_t v = 0; ok = ok && r.at<uint64_t>(off, &v); return v; }
          default: { uint32_t v = 0; ok = ok && r.at<uint32_t>(off, &v); return v; }
        }
      };
      if (tag == 270 && typ == 2) {  // ImageDescription: detect ImageJ
        uint64_t dlen = std::min<uint64_t>(n, 4096);
        if (r.has(data_pos, dlen)) {
          std::string d(reinterpret_cast<const char*>(r.p + data_pos), dlen);
          if (d.find("ImageJ") != std::string::npos &&
              d.find("images=") != std::string::npos)
            imagej_contig = true;
        }
      }
      switch (tag) {
        case 256: width = (uint32_t)read_val(0); break;
        case 257: height = (uint32_t)read_val(0); break;
        case 258: bits = (uint16_t)read_val(0); break;
        case 259: comp = (uint16_t)read_val(0); break;
        case 277: spp = (uint16_t)read_val(0); break;
        case 339: sfmt = (uint16_t)read_val(0); break;
        case 273:
          if (!r.has(data_pos, total)) return truncated("strip offsets");
          strip_offs.resize(n);
          for (uint64_t k = 0; k < n; ++k) strip_offs[k] = read_val(k);
          break;
        case 279:
          if (!r.has(data_pos, total)) return truncated("strip byte counts");
          strip_counts.resize(n);
          for (uint64_t k = 0; k < n; ++k) strip_counts[k] = read_val(k);
          break;
        default: break;
      }
      if (!ok) return truncated("tag data");
    }
    if (imagej_contig) {
      // ImageJ contiguous hyperstack: one IFD, true depth in the
      // description — the Python codec handles this layout
      *err = "ImageJ contiguous stack: deferring to the Python codec";
      return false;
    }
    if (comp != 1) { *err = "compressed TIFF not supported natively"; return false; }
    if (spp != 1) { *err = "multi-sample TIFF not supported natively"; return false; }
    if (strip_offs.size() != 1) { *err = "multi-strip pages not supported natively"; return false; }
    if (strip_counts.size() != 1) { *err = "pages without one strip byte count"; return false; }
    if (first) {
      info->width = width;
      info->height = height;
      info->bits = bits;
      info->sample_format = sfmt;
      first = false;
    } else if (width != info->width || height != info->height || bits != info->bits) {
      *err = "page geometry varies";
      return false;
    }
    const uint64_t px = (uint64_t)width * height;  // < 2^64: both are 32-bit
    if (px > r.n) return truncated("page data");
    const uint64_t nbytes = px * (bits / 8);
    if (strip_counts[0] < nbytes) {
      *err = "strip byte count less than the page";
      return false;
    }
    if (!r.has(strip_offs[0], nbytes)) return truncated("page data");
    info->pages.push_back({strip_offs[0], nbytes});
    const uint64_t next_pos = entry0 + count * entry_sz;  // inside the file: checked above
    if (big) {
      r.at<uint64_t>(next_pos, &ifd_off);
    } else {
      uint32_t o32 = 0;
      r.at<uint32_t>(next_pos, &o32);
      ifd_off = o32;
    }
  }
  if (info->pages.empty()) { *err = "no pages"; return false; }
  return true;
}

void decode_pages_f32(const Reader& r, const TiffInfo& info, float* out) {
  const uint64_t page_px = (uint64_t)info.width * info.height;
  const size_t n_pages = info.pages.size();
  unsigned n_threads = std::min<unsigned>(std::thread::hardware_concurrency(),
                                          (unsigned)n_pages);
  if (n_threads == 0) n_threads = 1;
  auto work = [&](size_t start, size_t step) {
    for (size_t i = start; i < n_pages; i += step) {
      const uint8_t* src = r.p + info.pages[i].data_off;
      float* dst = out + i * page_px;
      if (info.bits == 16) {
        const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
        for (uint64_t k = 0; k < page_px; ++k) dst[k] = (float)s[k];
      } else {  // 32-bit float
        std::memcpy(dst, src, page_px * 4);
      }
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) ts.emplace_back(work, t, n_threads);
  work(0, n_threads);
  for (auto& t : ts) t.join();
}

// float -> u16 with C-cast semantics: truncate toward zero, wrap mod 2^16
inline uint16_t f32_to_u16_c(float v) {
  if (!(v == v) || v > 9.2e18f || v < -9.2e18f) return 0;
  return (uint16_t)(int64_t)v;
}

struct TiffWriteCtx {
  uint32_t width, height, bits, sfmt;
  uint64_t page_bytes;
};

void build_header_and_ifds(const TiffWriteCtx& c, size_t n_pages,
                           std::vector<uint8_t>* out,
                           std::vector<uint64_t>* data_offsets) {
  // layout: 8-byte header, then per page: [data][ifd]
  const int n_entries = (c.sfmt != 1) ? 12 : 11;
  const uint64_t ifd_bytes = 2 + n_entries * 12 + 4;
  uint64_t pos = 8;
  std::vector<uint64_t> ifd_offsets(n_pages);
  data_offsets->resize(n_pages);
  for (size_t i = 0; i < n_pages; ++i) {
    if (pos % 2) pos += 1;
    (*data_offsets)[i] = pos;
    pos += c.page_bytes;
    if (pos % 2) pos += 1;
    ifd_offsets[i] = pos;
    pos += ifd_bytes;
  }
  out->assign(pos, 0);
  uint8_t* p = out->data();
  p[0] = 'I'; p[1] = 'I';
  uint16_t ver = 42;
  std::memcpy(p + 2, &ver, 2);
  uint32_t first = (uint32_t)ifd_offsets[0];
  std::memcpy(p + 4, &first, 4);
  for (size_t i = 0; i < n_pages; ++i) {
    uint8_t* e = p + ifd_offsets[i];
    uint16_t cnt = (uint16_t)n_entries;
    std::memcpy(e, &cnt, 2);
    e += 2;
    auto put = [&](uint16_t tag, uint16_t typ, uint32_t n, uint32_t val) {
      std::memcpy(e, &tag, 2);
      std::memcpy(e + 2, &typ, 2);
      std::memcpy(e + 4, &n, 4);
      std::memcpy(e + 8, &val, 4);
      e += 12;
    };
    put(256, 3, 1, c.width);
    put(257, 3, 1, c.height);
    put(258, 3, 1, c.bits);
    put(259, 3, 1, 1);               // no compression
    put(262, 3, 1, 1);               // min-is-black
    put(273, 4, 1, (uint32_t)(*data_offsets)[i]);
    put(274, 3, 1, 1);               // top-left
    put(277, 3, 1, 1);
    put(278, 3, 1, c.height);        // one strip per page
    put(279, 4, 1, (uint32_t)c.page_bytes);
    put(284, 3, 1, 2);               // planar separate, as the reference writes
    if (c.sfmt != 1) put(339, 3, 1, c.sfmt);
    uint32_t next = (i + 1 < n_pages) ? (uint32_t)ifd_offsets[i + 1] : 0;
    std::memcpy(e, &next, 4);
  }
}

// ---------------------------------------------------------------------------
// Python bindings (buffer protocol; numpy stays on the Python side)
// ---------------------------------------------------------------------------

PyObject* py_read_stack_f32(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    PyErr_Format(PyExc_FileNotFoundError, "*** File does not exist: %s", path);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  size_t got = std::fread(buf.data(), 1, sz, f);
  std::fclose(f);
  if ((long)got != sz) {
    PyErr_SetString(PyExc_IOError, "short read");
    return nullptr;
  }
  Reader r{buf.data(), (size_t)sz};
  TiffInfo info;
  std::string err;
  if (!parse_tiff(r, &info, &err)) {
    PyErr_Format(PyExc_ValueError, "miltiff: %s", err.c_str());
    return nullptr;
  }
  if (info.bits != 16 && !(info.bits == 32 && info.sample_format == 3)) {
    PyErr_SetString(PyExc_ValueError, "miltiff: only u16 / f32 supported");
    return nullptr;
  }
  const uint64_t page_px = (uint64_t)info.width * info.height;
  const size_t n_pages = info.pages.size();
  PyObject* bytes = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(n_pages * page_px * 4));
  if (!bytes) return nullptr;
  float* out = reinterpret_cast<float*>(PyBytes_AS_STRING(bytes));
  Py_BEGIN_ALLOW_THREADS
  decode_pages_f32(r, info, out);
  Py_END_ALLOW_THREADS
  // (bytes, width, height, n_pages, bits)
  return Py_BuildValue("(NIIIH)", bytes, info.width, info.height,
                       (unsigned int)n_pages, info.bits);
}

PyObject* py_write_stack(PyObject*, PyObject* args) {
  const char* path;
  Py_buffer view;
  unsigned int width, height, n_pages;
  int bits;
  // data is float32 C-contiguous (z, y, x)
  if (!PyArg_ParseTuple(args, "sy*IIIi", &path, &view, &width, &height, &n_pages, &bits))
    return nullptr;
  const float* data = reinterpret_cast<const float*>(view.buf);
  const uint64_t page_px = (uint64_t)width * height;
  if ((uint64_t)view.len < (uint64_t)n_pages * page_px * 4) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "buffer too small");
    return nullptr;
  }
  // classic-TIFF offsets are 32-bit; refuse rather than wrap silently
  if ((uint64_t)n_pages * page_px * (bits / 8) + 8 + (uint64_t)n_pages * 200 >= (1ull << 32)) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError,
                    "Stack exceeds the 4 GB classic-TIFF offset limit");
    return nullptr;
  }
  TiffWriteCtx c;
  c.width = width;
  c.height = height;
  c.bits = (uint32_t)bits;
  c.sfmt = (bits == 32) ? 3 : 1;
  c.page_bytes = page_px * (bits / 8);
  std::vector<uint8_t> out;
  std::vector<uint64_t> offs;
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  build_header_and_ifds(c, n_pages, &out, &offs);
  unsigned n_threads = std::min<unsigned>(std::thread::hardware_concurrency(),
                                          (unsigned)n_pages);
  if (n_threads == 0) n_threads = 1;
  auto work = [&](size_t start, size_t step) {
    for (size_t i = start; i < n_pages; i += step) {
      uint8_t* dst = out.data() + offs[i];
      const float* src = data + i * page_px;
      if (bits == 16) {
        uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
        for (uint64_t k = 0; k < page_px; ++k) d16[k] = f32_to_u16_c(src[k]);
      } else {
        std::memcpy(dst, src, page_px * 4);
      }
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) ts.emplace_back(work, t, n_threads);
  work(0, n_threads);
  for (auto& t : ts) t.join();
  FILE* f = std::fopen(path, "wb");
  if (f) {
    ok = std::fwrite(out.data(), 1, out.size(), f) == out.size();
    std::fclose(f);
  } else {
    ok = false;
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!ok) {
    PyErr_Format(PyExc_IOError, "*** Failed to create file!!! Please check the directory: %s", path);
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_get_info(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    PyErr_Format(PyExc_FileNotFoundError, "*** File does not exist: %s", path);
    return nullptr;
  }
  // headers + IFDs only: read up to 16 MB which covers any sane IFD chain
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  size_t got = std::fread(buf.data(), 1, sz, f);
  std::fclose(f);
  if ((long)got != sz) {
    PyErr_SetString(PyExc_IOError, "short read");
    return nullptr;
  }
  Reader r{buf.data(), (size_t)sz};
  TiffInfo info;
  std::string err;
  if (!parse_tiff(r, &info, &err)) {
    PyErr_Format(PyExc_ValueError, "miltiff: %s", err.c_str());
    return nullptr;
  }
  return Py_BuildValue("(IIIH)", info.width, info.height,
                       (unsigned int)info.pages.size(), info.bits);
}

PyMethodDef methods[] = {
    {"read_stack_f32", py_read_stack_f32, METH_VARARGS,
     "read_stack_f32(path) -> (bytes_f32, width, height, n_pages, bits)"},
    {"write_stack", py_write_stack, METH_VARARGS,
     "write_stack(path, f32_buffer, width, height, n_pages, bits)"},
    {"get_info", py_get_info, METH_VARARGS,
     "get_info(path) -> (width, height, n_pages, bits)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "miltiff",
                      "native parallel TIFF stack codec", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_miltiff(void) { return PyModule_Create(&module); }
