// Multi-threaded parser for whitespace-separated numeric chain files, the
// cold-load pass of loadMCSamples (getdist_tpu_torch/_native/__init__.py:
// load_chain_text; the port's own copy of getdist_tpu/_native/fastloader.cpp).
//
// The reference loads chains with np.loadtxt (getdist/chains.py:115), which
// parses on one thread. This loader memory-maps the file, splits it into
// chunks at line boundaries, and parses each chunk in parallel with
// std::from_chars (correctly rounded, as np.loadtxt is: the same doubles),
// into one host array.
//
// C ABI (used from Python via ctypes):
//   int gdt_parse_chain(const char* path, long skip_rows,
//                       double** out_data, long* out_rows, long* out_cols,
//                       char* err, long err_len);
//   void gdt_free(double* data);
//
// Returns 0 on success; 1 on malformed input (ragged rows, bad numbers) and
// 2 when the file cannot be read, each with a message in err.  The Python
// wrapper raises (ValueError for malformed input, naming the file); there
// is no fallback parser.

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Chunk {
    const char* begin;
    const char* end;
    std::vector<double> values;
    long rows = 0;
    long cols = -1;  // columns seen (must agree across rows)
    bool ok = true;
    std::string error;
};

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Parse [begin, end) consisting of whole lines.
void parse_chunk(Chunk* chunk) {
    const char* p = chunk->begin;
    const char* end = chunk->end;
    chunk->values.reserve(static_cast<size_t>((end - p) / 8));
    while (p < end) {
        const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        long cols_this_row = 0;
        const char* q = p;
        while (q < line_end) {
            while (q < line_end && is_space(*q)) ++q;
            if (q >= line_end || *q == '#') break;  // comment or end
            double value;
            auto [next, ec] = std::from_chars(q, line_end, value);
            if (ec != std::errc()) {
                // tolerate Fortran-style exponents and inf/nan via strtod
                char buf[64];
                size_t len = std::min<size_t>(63, line_end - q);
                memcpy(buf, q, len);
                buf[len] = 0;
                char* after = nullptr;
                value = strtod(buf, &after);
                if (after == buf) {
                    chunk->ok = false;
                    chunk->error = "unparseable token";
                    return;
                }
                next = q + (after - buf);
            }
            chunk->values.push_back(value);
            ++cols_this_row;
            q = next;
        }
        if (cols_this_row > 0) {
            if (chunk->cols < 0) {
                chunk->cols = cols_this_row;
            } else if (chunk->cols != cols_this_row) {
                chunk->ok = false;
                chunk->error = "ragged rows";
                return;
            }
            ++chunk->rows;
        }
        p = (line_end < end) ? line_end + 1 : end;
    }
}

}  // namespace

extern "C" {

int gdt_parse_chain(const char* path, long skip_rows, double** out_data, long* out_rows, long* out_cols, char* err,
                    long err_len) {
    auto fail = [&](const char* msg, int code = 1) {
        if (err && err_len > 0) {
            snprintf(err, static_cast<size_t>(err_len), "%s", msg);
        }
        return code;
    };

    int fd = open(path, O_RDONLY);
    if (fd < 0) return fail("cannot open file", 2);
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return fail("cannot stat file", 2);
    }
    if (st.st_size == 0) {
        close(fd);
        *out_data = nullptr;
        *out_rows = 0;
        *out_cols = 0;
        return 0;
    }
    const char* data = static_cast<const char*>(mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
    close(fd);
    if (data == MAP_FAILED) return fail("mmap failed", 2);
    const char* begin = data;
    const char* end = data + st.st_size;

    // skip initial rows (burn-in) before splitting
    for (long i = 0; i < skip_rows && begin < end; ++i) {
        const char* nl = static_cast<const char*>(memchr(begin, '\n', end - begin));
        begin = nl ? nl + 1 : end;
    }

    unsigned n_threads = std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
    if (static_cast<size_t>(end - begin) < (1u << 20)) n_threads = 1;

    std::vector<Chunk> chunks(n_threads);
    const char* cursor = begin;
    size_t chunk_size = static_cast<size_t>(end - begin) / n_threads + 1;
    for (unsigned t = 0; t < n_threads; ++t) {
        const char* cbegin = cursor;
        const char* cend = std::min(end, cbegin + chunk_size);
        // advance to a line boundary
        if (cend < end) {
            const char* nl = static_cast<const char*>(memchr(cend, '\n', end - cend));
            cend = nl ? nl + 1 : end;
        }
        chunks[t].begin = cbegin;
        chunks[t].end = cend;
        cursor = cend;
    }

    std::vector<std::thread> workers;
    for (auto& chunk : chunks) {
        workers.emplace_back(parse_chunk, &chunk);
    }
    for (auto& w : workers) w.join();

    long cols = -1;
    long rows = 0;
    for (auto& chunk : chunks) {
        if (!chunk.ok) {
            munmap(const_cast<char*>(data), st.st_size);
            return fail(chunk.error.c_str());
        }
        if (chunk.cols >= 0) {
            if (cols < 0) {
                cols = chunk.cols;
            } else if (cols != chunk.cols) {
                munmap(const_cast<char*>(data), st.st_size);
                return fail("ragged rows across chunks");
            }
            rows += chunk.rows;
        }
    }
    munmap(const_cast<char*>(data), st.st_size);
    if (cols <= 0 || rows == 0) {
        *out_data = nullptr;
        *out_rows = 0;
        *out_cols = 0;
        return 0;
    }

    double* out = static_cast<double*>(malloc(sizeof(double) * static_cast<size_t>(rows) * cols));
    if (!out) return fail("allocation failed", 2);
    size_t offset = 0;
    for (auto& chunk : chunks) {
        if (!chunk.values.empty()) {
            memcpy(out + offset, chunk.values.data(), chunk.values.size() * sizeof(double));
            offset += chunk.values.size();
        }
    }
    *out_data = out;
    *out_rows = rows;
    *out_cols = cols;
    return 0;
}

void gdt_free(double* data) { free(data); }

}  // extern "C"
