/* Fast codecs for the pure-python zarr reader (minizarr).
 *
 * CPython extension module `_fastcodec` providing the two hot loops the
 * python fallback implements slowly:
 *   - lz4_decompress(src, dst_size): LZ4 *block* format decoder (the
 *     inner codec of the default blosc compressor in zarr stores)
 *   - byte_unshuffle(src, typesize): inverse of blosc's byte shuffle
 *
 * Counterpart of the native codec layer the reference delegates to
 * numcodecs/blosc wheels (reference: neural_lam/datastore/mdp.py uses
 * xr.open_zarr, whose chunks are blosc-lz4 by default). Built with
 * `python -m neural_lam_tpu_torch.native.build`; minizarr falls back to the
 * pure-python decoders when the extension is absent.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

static PyObject *
lz4_decompress(PyObject *self, PyObject *args)
{
    Py_buffer src;
    Py_ssize_t dst_size;
    if (!PyArg_ParseTuple(args, "y*n", &src, &dst_size))
        return NULL;
    if (dst_size < 0) {
        PyBuffer_Release(&src);
        PyErr_SetString(PyExc_ValueError, "negative dst_size");
        return NULL;
    }

    PyObject *out = PyBytes_FromStringAndSize(NULL, dst_size);
    if (out == NULL) {
        PyBuffer_Release(&src);
        return NULL;
    }
    unsigned char *dst = (unsigned char *)PyBytes_AS_STRING(out);
    const unsigned char *ip = (const unsigned char *)src.buf;
    const unsigned char *iend = ip + src.len;
    Py_ssize_t op = 0;

    while (ip < iend && op < dst_size) {
        unsigned token = *ip++;
        /* literal run */
        Py_ssize_t lit = token >> 4;
        if (lit == 15) {
            unsigned b;
            do {
                if (ip >= iend) goto corrupt;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > dst_size) goto corrupt;
        memcpy(dst + op, ip, (size_t)lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break; /* last sequence: literals only */

        /* match */
        if (ip + 2 > iend) goto corrupt;
        Py_ssize_t offset = ip[0] | ((Py_ssize_t)ip[1] << 8);
        ip += 2;
        if (offset == 0 || offset > op) goto corrupt;
        Py_ssize_t mlen = token & 0xF;
        if (mlen == 15) {
            unsigned b;
            do {
                if (ip >= iend) goto corrupt;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (op + mlen > dst_size) goto corrupt;
        {
            /* overlapping copy must run forward byte-by-byte */
            unsigned char *d = dst + op;
            const unsigned char *s = dst + op - offset;
            for (Py_ssize_t k = 0; k < mlen; k++)
                d[k] = s[k];
        }
        op += mlen;
    }

    PyBuffer_Release(&src);
    if (op != dst_size) {
        /* Allow short output only if input consumed exactly */
        if (_PyBytes_Resize(&out, op) < 0)
            return NULL;
    }
    return out;

corrupt:
    PyBuffer_Release(&src);
    Py_DECREF(out);
    PyErr_SetString(PyExc_ValueError, "corrupt LZ4 block");
    return NULL;
}

static PyObject *
byte_unshuffle(PyObject *self, PyObject *args)
{
    Py_buffer src;
    Py_ssize_t typesize;
    if (!PyArg_ParseTuple(args, "y*n", &src, &typesize))
        return NULL;
    if (typesize <= 0 || src.len % typesize != 0) {
        PyBuffer_Release(&src);
        PyErr_SetString(
            PyExc_ValueError, "length not divisible by typesize");
        return NULL;
    }
    Py_ssize_t n = src.len / typesize;
    PyObject *out = PyBytes_FromStringAndSize(NULL, src.len);
    if (out == NULL) {
        PyBuffer_Release(&src);
        return NULL;
    }
    unsigned char *dst = (unsigned char *)PyBytes_AS_STRING(out);
    const unsigned char *s = (const unsigned char *)src.buf;
    /* input layout: typesize planes of n bytes; output: interleaved */
    for (Py_ssize_t t = 0; t < typesize; t++) {
        const unsigned char *plane = s + t * n;
        for (Py_ssize_t i = 0; i < n; i++)
            dst[i * typesize + t] = plane[i];
    }
    PyBuffer_Release(&src);
    return out;
}

static PyMethodDef FastcodecMethods[] = {
    {"lz4_decompress", lz4_decompress, METH_VARARGS,
     "Decode an LZ4 block into dst_size bytes."},
    {"byte_unshuffle", byte_unshuffle, METH_VARARGS,
     "Inverse blosc byte shuffle."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef fastcodecmodule = {
    PyModuleDef_HEAD_INIT, "_fastcodec",
    "Native codecs for minizarr", -1, FastcodecMethods};

PyMODINIT_FUNC
PyInit__fastcodec(void)
{
    return PyModule_Create(&fastcodecmodule);
}
