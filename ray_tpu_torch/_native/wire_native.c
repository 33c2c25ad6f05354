/* wire_native: compact tagged binary codec for ray_tpu_torch control messages.
 *
 * The control plane's per-message cost is dominated by pickling small,
 * fixed-shape tuples (submit/exec/done/batch/ref-op frames): the C pickler
 * pays generic machinery (memo table, framing, protocol opcodes) that a
 * purpose-built codec does not need. This module encodes the closed set of
 * "simple" Python values (None, bool, int64, float, bytes, str, tuple,
 * list, dict) directly, and escapes to Python-level hooks for everything
 * else — the hooks flatten the runtime's dataclasses (TaskSpec, ObjectMeta,
 * ExecRequest, ids, ...) to simple field tuples and pickle anything truly
 * arbitrary (see ray_tpu_torch/_private/wire.py, which also implements the SAME
 * format in pure Python as the no-toolchain fallback and the parity-fuzz
 * reference).
 *
 * Format (little-endian):
 *   'N'            None            'T'/'F'  True/False
 *   'i' + i64      int             'f' + f64  float
 *   'b' + u32 + data   bytes       's' + u32 + utf8   str
 *   't'/'l' + u32 + items          tuple / list
 *   'd' + u32 + key,value pairs    dict (insertion order preserved)
 *   'H' + u8 tag + payload         hook-encoded object
 *
 * Errors raise ValueError; callers fall back to pickle for the whole
 * message, so an unencodable value costs the attempt, never correctness.
 *
 * Built with the same on-demand g++ flow as shm_arena (ray_tpu_torch/_native/
 * __init__.py); no toolchain => the pure-Python codec serves.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

#define WIRE_MAX_DEPTH 100

/* Source-hash stamp: the build flow (_native/__init__.py) passes
 * -DWIRE_SRC_SHA256="<hex>" with the sha256 of THIS file, exported both as a
 * module constant (SOURCE_HASH) and as a greppable marker string inside the
 * binary, so a checked-in .so that no longer matches its source is
 * detectable without loading it (tools/check.sh stale-binary guard). */
#ifndef WIRE_SRC_SHA256
#define WIRE_SRC_SHA256 "unknown"
#endif
__attribute__((used)) static const char wire_src_marker[] =
    "RAY_TPU_TORCH_WIRE_SRC_SHA256=" WIRE_SRC_SHA256;

static PyObject *enc_hook = NULL; /* obj -> (tag:int 0..255, payload) | None */
static PyObject *dec_hook = NULL; /* (tag, payload) -> obj */

/* Decode-side frame ceiling (config knob wire_max_frame_bytes, pushed in by
 * wire.py via set_limits). A frame larger than this is rejected up front —
 * no interior length field of a hostile frame is ever trusted into an
 * allocation bigger than the frame itself (see the count checks below). */
static Py_ssize_t max_frame_bytes = 256 * 1024 * 1024;

/* ------------------------------------------------------------------ writer */
typedef struct {
    char *buf;
    Py_ssize_t len;
    Py_ssize_t cap;
} Writer;

static int w_init(Writer *w, Py_ssize_t cap) {
    w->buf = (char *)PyMem_Malloc(cap);
    if (!w->buf) {
        PyErr_NoMemory();
        return -1;
    }
    w->len = 0;
    w->cap = cap;
    return 0;
}

static int w_reserve(Writer *w, Py_ssize_t extra) {
    if (w->len + extra <= w->cap)
        return 0;
    Py_ssize_t cap = w->cap * 2;
    while (cap < w->len + extra)
        cap *= 2;
    char *nb = (char *)PyMem_Realloc(w->buf, cap);
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    w->buf = nb;
    w->cap = cap;
    return 0;
}

static inline int w_byte(Writer *w, char c) {
    if (w_reserve(w, 1) < 0)
        return -1;
    w->buf[w->len++] = c;
    return 0;
}

static inline int w_raw(Writer *w, const void *p, Py_ssize_t n) {
    if (w_reserve(w, n) < 0)
        return -1;
    memcpy(w->buf + w->len, p, n);
    w->len += n;
    return 0;
}

static inline int w_u32(Writer *w, Py_ssize_t v) {
    if (v < 0 || v > 0xFFFFFFFFLL) {
        PyErr_SetString(PyExc_ValueError, "wire: length exceeds u32");
        return -1;
    }
    uint32_t u = (uint32_t)v;
    return w_raw(w, &u, 4);
}

/* ----------------------------------------------------------------- encoder */
static int encode_obj(Writer *w, PyObject *o, int depth);

static int encode_via_hook(Writer *w, PyObject *o, int depth) {
    if (!enc_hook) {
        PyErr_SetString(PyExc_ValueError, "wire: no encode hook installed");
        return -1;
    }
    PyObject *r = PyObject_CallFunctionObjArgs(enc_hook, o, NULL);
    if (!r)
        return -1;
    if (r == Py_None) {
        Py_DECREF(r);
        PyErr_SetString(PyExc_ValueError, "wire: hook declined object");
        return -1;
    }
    if (!PyTuple_CheckExact(r) || PyTuple_GET_SIZE(r) != 2) {
        Py_DECREF(r);
        PyErr_SetString(PyExc_ValueError, "wire: hook must return (tag, payload)");
        return -1;
    }
    long tag = PyLong_AsLong(PyTuple_GET_ITEM(r, 0));
    if (tag < 0 || tag > 255) {
        Py_DECREF(r);
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "wire: hook tag out of range");
        return -1;
    }
    if (w_byte(w, 'H') < 0 || w_byte(w, (char)(unsigned char)tag) < 0) {
        Py_DECREF(r);
        return -1;
    }
    int rc = encode_obj(w, PyTuple_GET_ITEM(r, 1), depth + 1);
    Py_DECREF(r);
    return rc;
}

static int encode_obj(Writer *w, PyObject *o, int depth) {
    if (depth > WIRE_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "wire: max depth exceeded");
        return -1;
    }
    if (o == Py_None)
        return w_byte(w, 'N');
    if (o == Py_True)
        return w_byte(w, 'T');
    if (o == Py_False)
        return w_byte(w, 'F');
    PyTypeObject *t = Py_TYPE(o);
    if (t == &PyLong_Type) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
        if (overflow)
            return encode_via_hook(w, o, depth); /* big ints: pickle leaf */
        if (v == -1 && PyErr_Occurred())
            return -1;
        if (w_byte(w, 'i') < 0)
            return -1;
        int64_t iv = (int64_t)v;
        return w_raw(w, &iv, 8);
    }
    if (t == &PyFloat_Type) {
        double d = PyFloat_AS_DOUBLE(o);
        if (w_byte(w, 'f') < 0)
            return -1;
        return w_raw(w, &d, 8);
    }
    if (t == &PyBytes_Type) {
        Py_ssize_t n = PyBytes_GET_SIZE(o);
        if (w_byte(w, 'b') < 0 || w_u32(w, n) < 0)
            return -1;
        return w_raw(w, PyBytes_AS_STRING(o), n);
    }
    if (t == &PyUnicode_Type) {
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(o, &n);
        if (!s)
            return -1;
        if (w_byte(w, 's') < 0 || w_u32(w, n) < 0)
            return -1;
        return w_raw(w, s, n);
    }
    if (t == &PyTuple_Type) {
        Py_ssize_t n = PyTuple_GET_SIZE(o);
        if (w_byte(w, 't') < 0 || w_u32(w, n) < 0)
            return -1;
        for (Py_ssize_t i = 0; i < n; i++)
            if (encode_obj(w, PyTuple_GET_ITEM(o, i), depth + 1) < 0)
                return -1;
        return 0;
    }
    if (t == &PyList_Type) {
        Py_ssize_t n = PyList_GET_SIZE(o);
        if (w_byte(w, 'l') < 0 || w_u32(w, n) < 0)
            return -1;
        for (Py_ssize_t i = 0; i < n; i++)
            if (encode_obj(w, PyList_GET_ITEM(o, i), depth + 1) < 0)
                return -1;
        return 0;
    }
    if (t == &PyDict_Type) {
        Py_ssize_t n = PyDict_GET_SIZE(o);
        if (w_byte(w, 'd') < 0 || w_u32(w, n) < 0)
            return -1;
        Py_ssize_t pos = 0;
        PyObject *k, *v;
        while (PyDict_Next(o, &pos, &k, &v)) {
            if (encode_obj(w, k, depth + 1) < 0 || encode_obj(w, v, depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    return encode_via_hook(w, o, depth);
}

/* ----------------------------------------------------------------- decoder */
typedef struct {
    const char *p;
    const char *end;
} Reader;

static int r_need(Reader *r, Py_ssize_t n) {
    if (r->end - r->p < n) {
        PyErr_SetString(PyExc_ValueError, "wire: truncated frame");
        return -1;
    }
    return 0;
}

static PyObject *decode_obj(Reader *r, int depth);

static int r_u32(Reader *r, uint32_t *out) {
    if (r_need(r, 4) < 0)
        return -1;
    memcpy(out, r->p, 4);
    r->p += 4;
    return 0;
}

static PyObject *decode_obj(Reader *r, int depth) {
    if (depth > WIRE_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "wire: max depth exceeded");
        return NULL;
    }
    if (r_need(r, 1) < 0)
        return NULL;
    char tag = *r->p++;
    switch (tag) {
    case 'N':
        Py_RETURN_NONE;
    case 'T':
        Py_RETURN_TRUE;
    case 'F':
        Py_RETURN_FALSE;
    case 'i': {
        if (r_need(r, 8) < 0)
            return NULL;
        int64_t v;
        memcpy(&v, r->p, 8);
        r->p += 8;
        return PyLong_FromLongLong((long long)v);
    }
    case 'f': {
        if (r_need(r, 8) < 0)
            return NULL;
        double d;
        memcpy(&d, r->p, 8);
        r->p += 8;
        return PyFloat_FromDouble(d);
    }
    case 'b': {
        uint32_t n;
        if (r_u32(r, &n) < 0 || r_need(r, n) < 0)
            return NULL;
        PyObject *o = PyBytes_FromStringAndSize(r->p, n);
        r->p += n;
        return o;
    }
    case 's': {
        uint32_t n;
        if (r_u32(r, &n) < 0 || r_need(r, n) < 0)
            return NULL;
        PyObject *o = PyUnicode_DecodeUTF8(r->p, n, NULL);
        r->p += n;
        return o;
    }
    case 't': {
        uint32_t n;
        if (r_u32(r, &n) < 0)
            return NULL;
        /* Each element costs at least 1 byte: a count beyond the remaining
         * input is a lie — reject BEFORE presizing (a 5-byte frame claiming
         * 2^32-1 elements must not allocate a 34GB container). */
        if ((Py_ssize_t)n > r->end - r->p) {
            PyErr_SetString(PyExc_ValueError, "wire: truncated frame");
            return NULL;
        }
        PyObject *tup = PyTuple_New(n);
        if (!tup)
            return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *item = decode_obj(r, depth + 1);
            if (!item) {
                Py_DECREF(tup);
                return NULL;
            }
            PyTuple_SET_ITEM(tup, i, item);
        }
        return tup;
    }
    case 'l': {
        uint32_t n;
        if (r_u32(r, &n) < 0)
            return NULL;
        if ((Py_ssize_t)n > r->end - r->p) {
            PyErr_SetString(PyExc_ValueError, "wire: truncated frame");
            return NULL;
        }
        PyObject *lst = PyList_New(n);
        if (!lst)
            return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *item = decode_obj(r, depth + 1);
            if (!item) {
                Py_DECREF(lst);
                return NULL;
            }
            PyList_SET_ITEM(lst, i, item);
        }
        return lst;
    }
    case 'd': {
        uint32_t n;
        if (r_u32(r, &n) < 0)
            return NULL;
        /* A pair costs at least 2 bytes; unlike PyList_New's lazy pages,
         * the presized dict table is TOUCHED, so this bound matters. */
        if ((Py_ssize_t)n > (r->end - r->p) / 2) {
            PyErr_SetString(PyExc_ValueError, "wire: truncated frame");
            return NULL;
        }
        PyObject *dct = _PyDict_NewPresized(n);
        if (!dct)
            return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *k = decode_obj(r, depth + 1);
            if (!k) {
                Py_DECREF(dct);
                return NULL;
            }
            PyObject *v = decode_obj(r, depth + 1);
            if (!v) {
                Py_DECREF(k);
                Py_DECREF(dct);
                return NULL;
            }
            if (PyDict_SetItem(dct, k, v) < 0) {
                Py_DECREF(k);
                Py_DECREF(v);
                Py_DECREF(dct);
                /* Unhashable key: the encoder never emits container keys,
                 * so this is a forged/corrupt frame — typed rejection
                 * (fuzzer-found; keep in sync with the Python twin). */
                if (PyErr_ExceptionMatches(PyExc_TypeError)) {
                    PyErr_Clear();
                    PyErr_SetString(PyExc_ValueError,
                                    "wire: unhashable dict key in frame");
                }
                return NULL;
            }
            Py_DECREF(k);
            Py_DECREF(v);
        }
        return dct;
    }
    case 'H': {
        if (r_need(r, 1) < 0)
            return NULL;
        unsigned char htag = (unsigned char)*r->p++;
        PyObject *payload = decode_obj(r, depth + 1);
        if (!payload)
            return NULL;
        if (!dec_hook) {
            Py_DECREF(payload);
            PyErr_SetString(PyExc_ValueError, "wire: no decode hook installed");
            return NULL;
        }
        PyObject *tagobj = PyLong_FromLong((long)htag);
        if (!tagobj) {
            Py_DECREF(payload);
            return NULL;
        }
        PyObject *out = PyObject_CallFunctionObjArgs(dec_hook, tagobj, payload, NULL);
        Py_DECREF(tagobj);
        Py_DECREF(payload);
        return out;
    }
    default:
        PyErr_Format(PyExc_ValueError, "wire: unknown type byte 0x%02x",
                     (unsigned char)tag);
        return NULL;
    }
}

/* ------------------------------------------------------------- module API */
static PyObject *py_pack(PyObject *self, PyObject *arg) {
    Writer w;
    if (w_init(&w, 256) < 0)
        return NULL;
    if (encode_obj(&w, arg, 0) < 0) {
        PyMem_Free(w.buf);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
}

static PyObject *py_unpack(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t offset = 0;
    if (!PyArg_ParseTuple(args, "y*|n", &view, &offset))
        return NULL;
    if (offset < 0 || offset > view.len) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "wire: bad offset");
        return NULL;
    }
    if (view.len - offset > max_frame_bytes) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError,
                        "wire: frame exceeds wire_max_frame_bytes");
        return NULL;
    }
    Reader r = {(const char *)view.buf + offset,
                (const char *)view.buf + view.len};
    PyObject *out = decode_obj(&r, 0);
    if (out && r.p != r.end) {
        Py_DECREF(out);
        out = NULL;
        PyErr_SetString(PyExc_ValueError, "wire: trailing bytes in frame");
    }
    PyBuffer_Release(&view);
    return out;
}

static PyObject *py_set_hooks(PyObject *self, PyObject *args) {
    PyObject *enc, *dec;
    if (!PyArg_ParseTuple(args, "OO", &enc, &dec))
        return NULL;
    Py_XINCREF(enc);
    Py_XINCREF(dec);
    Py_XSETREF(enc_hook, enc == Py_None ? NULL : enc);
    Py_XSETREF(dec_hook, dec == Py_None ? NULL : dec);
    if (enc == Py_None)
        Py_XDECREF(enc); /* balanced: we incref'd but stored NULL */
    if (dec == Py_None)
        Py_XDECREF(dec);
    Py_RETURN_NONE;
}

static PyObject *py_set_limits(PyObject *self, PyObject *args) {
    Py_ssize_t max_frame;
    if (!PyArg_ParseTuple(args, "n", &max_frame))
        return NULL;
    if (max_frame <= 0) {
        PyErr_SetString(PyExc_ValueError, "wire: max_frame_bytes must be > 0");
        return NULL;
    }
    max_frame_bytes = max_frame;
    Py_RETURN_NONE;
}

static PyMethodDef wire_methods[] = {
    {"pack", py_pack, METH_O,
     "pack(obj) -> bytes — encode a simple-value structure (hooks for the rest)."},
    {"unpack", py_unpack, METH_VARARGS,
     "unpack(data[, offset]) -> obj — decode a frame produced by pack()."},
    {"set_hooks", py_set_hooks, METH_VARARGS,
     "set_hooks(encode_cb, decode_cb) — install the dataclass/pickle escape hooks."},
    {"set_limits", py_set_limits, METH_VARARGS,
     "set_limits(max_frame_bytes) — decode-side frame-size ceiling."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef wire_module = {
    PyModuleDef_HEAD_INIT, "wire_native",
    "Compact tagged wire codec for ray_tpu_torch control messages.", -1, wire_methods,
};

PyMODINIT_FUNC PyInit_wire_native(void) {
    PyObject *mod = PyModule_Create(&wire_module);
    if (!mod)
        return NULL;
    /* Stale-binary guard: the hash of the source this .so was built from. */
    if (PyModule_AddStringConstant(mod, "SOURCE_HASH", WIRE_SRC_SHA256) < 0) {
        Py_DECREF(mod);
        return NULL;
    }
    return mod;
}
