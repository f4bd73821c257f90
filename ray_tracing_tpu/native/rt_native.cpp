// rt_native — C++ runtime components of ray_tracing_tpu.
//
// The reference is a C11 program whose runtime (scene parsing, screenshot
// encoding, event queue, OS threading) is all native (src/scene.c,
// src/main.c:637-681, src/gpu_and_windowing.c:19-22, src/os.c). This file
// provides the framework's native equivalents behind a C ABI consumed
// via ctypes:
//
//   * rt_parse_scene  — the scene DSL parser (grammar of src/scene.c:206-609,
//                       same defaults/validation/quirks as the Python parser;
//                       cross-checked against it in tests)
//   * rt_write_png    — PNG encoder for screenshots (replaces
//                       stb_image_write; zlib stream with stored blocks)
//   * rt_events_*     — 512-slot ring-buffer keyboard event queue fed by a
//                       reader thread in raw terminal mode (replaces the
//                       GLFW callback queue, src/gpu_and_windowing.c:220-269)
//
// Build: make -C ray_tracing_tpu/native  (g++ -O2 -fPIC -shared)

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>

#include <fcntl.h>
#include <termios.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Scene parser
// ---------------------------------------------------------------------------

// Packed object layout matches kernels/megakernel.py pack_scene():
// p0[3] p1[3] albedo[3] roughness reflectance metallic emission[3] pad
// (emission stored UN-premultiplied here: emission_color[3] + power in pad
// slot 15, so the Python side keeps full fidelity.)
enum { COL_P0 = 0, COL_P1 = 3, COL_ALB = 6, COL_ROUGH = 9, COL_REFL = 10,
       COL_METAL = 11, COL_EMITC = 12, COL_POWER = 15, NCOLS = 16 };

enum { OBJ_SPHERE = 1, OBJ_CUBE = 2 };

struct Cursor {
    const char* s;
    size_t n;
    size_t i = 0;
    int line = 1;

    bool eof() const { return i >= n; }
    char peek() const { return i < n ? s[i] : '\0'; }
    void skip_spaces() {
        while (i < n && (s[i] == ' ' || s[i] == '\r' || s[i] == '\t' || s[i] == '\n')) {
            if (s[i] == '\n') line++;
            i++;
        }
    }
    void skip_raw(int count) {
        // the reference's albedo/metallic cursor quirk (src/scene.c:280,
        // :320): advance EXACTLY count chars, whatever they are — values
        // with <3 spaces after those two property names lose leading chars
        size_t end = i + static_cast<size_t>(count);
        while (i < n && i < end) {
            if (s[i] == '\n') line++;
            i++;
        }
    }
    bool match(const char* w) {
        size_t len = strlen(w);
        if (i + len <= n && memcmp(s + i, w, len) == 0) {
            i += len;
            return true;
        }
        return false;
    }
};

static bool fail(char* err, size_t errlen, int line, const char* msg) {
    if (err && errlen) snprintf(err, errlen, "%s (line %d)", msg, line);
    return false;
}

// Reference number grammar: -?digits(.digits)? — no exponents/leading dots
// (src/scene.c:427-461).
static bool parse_number(Cursor& c, float* out, char* err, size_t errlen) {
    double sign = 1.0;
    if (c.peek() == '-') {
        sign = -1.0;
        c.i++;
        if (c.eof() || !isdigit(static_cast<unsigned char>(c.peek())))
            return fail(err, errlen, c.line, "Error: Missing number after minus sign");
    } else if (c.eof() || !isdigit(static_cast<unsigned char>(c.peek()))) {
        return fail(err, errlen, c.line, "Error: Missing number");
    }
    double v = 0;
    while (!c.eof() && isdigit(static_cast<unsigned char>(c.peek()))) {
        v = v * 10 + (c.peek() - '0');
        c.i++;
    }
    if (!c.eof() && c.peek() == '.') {
        c.i++;
        if (c.eof() || !isdigit(static_cast<unsigned char>(c.peek())))
            return fail(err, errlen, c.line, "Error: Missing decimal part after dot");
        double q = 0.1;
        while (!c.eof() && isdigit(static_cast<unsigned char>(c.peek()))) {
            v += q * (c.peek() - '0');
            q /= 10;
            c.i++;
        }
    }
    *out = static_cast<float>(sign * v);
    return true;
}

static bool parse_vector(Cursor& c, float out[3], char* err, size_t errlen) {
    if (c.peek() != '{')
        return fail(err, errlen, c.line, "Error: Missing '{' after property name");
    c.i++;
    for (int j = 0; j < 3; j++) {
        c.skip_spaces();
        if (!parse_number(c, &out[j], err, errlen)) return false;
    }
    c.skip_spaces();
    if (c.eof() || c.peek() != '}')
        return fail(err, errlen, c.line, "Error: Missing '}' after property value");
    c.i++;
    return true;
}

static bool unit_range(const float* v, int k) {
    for (int j = 0; j < k; j++)
        if (v[j] < 0 || v[j] > 1) return false;
    return true;
}

// Parses the DSL. Returns object count (>= 0) or -1 with err filled.
// params: caller-allocated max_objects x 16 floats; types: max_objects ints.
int rt_parse_scene(const char* src, long len, float* params, int* types,
                   int max_objects, char* err, long errlen) {
    Cursor c{src, static_cast<size_t>(len)};
    int count = 0;
    int dropped = 0;

    while (true) {
        c.skip_spaces();
        if (c.eof()) break;

        float row[NCOLS];
        // defaults, src/scene.c:232-254
        float* p0 = row + COL_P0;
        float* p1 = row + COL_P1;
        float* alb = row + COL_ALB;
        float* emitc = row + COL_EMITC;
        p0[0] = p0[1] = p0[2] = 0;
        alb[0] = 0.44f; alb[1] = 0.68f; alb[2] = 0.84f;
        row[COL_ROUGH] = 0; row[COL_REFL] = 0.2f; row[COL_METAL] = 0;
        emitc[0] = emitc[1] = emitc[2] = 1;
        row[COL_POWER] = 0;

        int type;
        if (c.match("sphere")) {
            type = OBJ_SPHERE;
            p1[0] = p1[1] = p1[2] = 1;  // radius
        } else if (c.match("cube")) {
            type = OBJ_CUBE;
            p1[0] = p1[1] = p1[2] = 1;  // size
        } else {
            fail(err, errlen, c.line, "Error: Invalid character");
            return -1;
        }

        while (true) {
            c.skip_spaces();
            float fval;
            float vval[3];
            int line = c.line;
            // NOTE: order matters for prefix-free matching; the
            // albedo/metallic cursor quirk eats 3 RAW chars (skip_raw).
            if (c.match("albedo")) {
                c.skip_raw(3);
                c.skip_spaces();
                if (!parse_vector(c, vval, err, errlen)) return -1;
                if (!unit_range(vval, 3)) { fail(err, errlen, line, "Error: albedo values must be between 0 and 1"); return -1; }
                memcpy(alb, vval, sizeof vval);
            } else if (c.match("roughness")) {
                c.skip_spaces();
                if (!parse_number(c, &fval, err, errlen)) return -1;
                if (!unit_range(&fval, 1)) { fail(err, errlen, line, "Error: Roughness must be between 0 and 1"); return -1; }
                row[COL_ROUGH] = fval;
            } else if (c.match("reflectance")) {
                c.skip_spaces();
                if (!parse_number(c, &fval, err, errlen)) return -1;
                if (!unit_range(&fval, 1)) { fail(err, errlen, line, "Error: Reflectance must be between 0 and 1"); return -1; }
                row[COL_REFL] = fval;
            } else if (c.match("metallic")) {
                c.skip_raw(3);
                c.skip_spaces();
                if (!parse_number(c, &fval, err, errlen)) return -1;
                if (!unit_range(&fval, 1)) { fail(err, errlen, line, "Error: Metallic must be between 0 and 1"); return -1; }
                row[COL_METAL] = fval;
            } else if (c.match("emission_power")) {
                c.skip_spaces();
                if (!parse_number(c, &fval, err, errlen)) return -1;
                row[COL_POWER] = fval;
            } else if (c.match("emission_color")) {
                c.skip_spaces();
                if (!parse_vector(c, vval, err, errlen)) return -1;
                if (!unit_range(vval, 3)) { fail(err, errlen, line, "Error: Emission color values must be between 0 and 1"); return -1; }
                memcpy(emitc, vval, sizeof vval);
            } else if (c.match("radius")) {
                if (type != OBJ_SPHERE) { fail(err, errlen, line, "Property 'radius' only allowed on spheres"); return -1; }
                c.skip_spaces();
                if (!parse_number(c, &fval, err, errlen)) return -1;
                p1[0] = p1[1] = p1[2] = fval;
            } else if (c.match("center")) {
                if (type != OBJ_SPHERE) { fail(err, errlen, line, "Property 'center' only allowed on spheres"); return -1; }
                c.skip_spaces();
                if (!parse_vector(c, vval, err, errlen)) return -1;
                memcpy(p0, vval, sizeof vval);
            } else if (c.match("origin")) {
                if (type != OBJ_CUBE) { fail(err, errlen, line, "Property 'origin' only allowed on cubes"); return -1; }
                c.skip_spaces();
                if (!parse_vector(c, vval, err, errlen)) return -1;
                memcpy(p0, vval, sizeof vval);
            } else if (c.match("size")) {
                if (type != OBJ_CUBE) { fail(err, errlen, line, "Property 'size' only allowed on cubes"); return -1; }
                c.skip_spaces();
                if (!parse_vector(c, vval, err, errlen)) return -1;
                if (vval[0] < 0 || vval[1] < 0 || vval[2] < 0) { fail(err, errlen, line, "Error: Size values must be positive"); return -1; }
                memcpy(p1, vval, sizeof vval);
            } else {
                break;  // not a property -> next object / EOF
            }
        }

        if (count >= max_objects) {
            // reference warns and drops (src/scene.c:602-605)
            dropped++;
            fprintf(stderr,
                    "Warning: Ignoring object because the scene is too big (line %d)\n",
                    c.line);
        } else {
            memcpy(params + static_cast<size_t>(count) * NCOLS, row, sizeof row);
            types[count] = type;
            count++;
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// PNG writer (screenshots; replaces stb_image_write, src/main.c:672-673)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static std::once_flag crc_once;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
}

static uint32_t crc32_of(const uint8_t* buf, size_t len, uint32_t crc = 0xFFFFFFFFu) {
    for (size_t i = 0; i < len; i++) crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return crc;
}

static void put_u32(std::string& s, uint32_t v) {
    s.push_back(static_cast<char>(v >> 24));
    s.push_back(static_cast<char>(v >> 16));
    s.push_back(static_cast<char>(v >> 8));
    s.push_back(static_cast<char>(v));
}

static void chunk(std::string& out, const char type[4], const std::string& data) {
    put_u32(out, static_cast<uint32_t>(data.size()));
    std::string body(type, 4);
    body += data;
    out += body;
    uint32_t crc = crc32_of(reinterpret_cast<const uint8_t*>(body.data()), body.size());
    put_u32(out, crc ^ 0xFFFFFFFFu);
}

// rgb: h*w*3 bytes. flip: write rows bottom-up like the reference
// (stbi_flip_vertically_on_write, src/main.c:672). Returns 0 on success.
int rt_write_png(const char* path, int w, int h, const uint8_t* rgb, int flip) {
    std::call_once(crc_once, crc_init);

    // raw scanlines with filter byte 0
    std::string raw;
    raw.reserve(static_cast<size_t>(h) * (1 + static_cast<size_t>(w) * 3));
    for (int y = 0; y < h; y++) {
        int row = flip ? (h - 1 - y) : y;
        raw.push_back('\0');
        raw.append(reinterpret_cast<const char*>(rgb + static_cast<size_t>(row) * w * 3),
                   static_cast<size_t>(w) * 3);
    }

    // zlib stream: stored (uncompressed) deflate blocks + adler32
    std::string z;
    z.push_back(0x78);
    z.push_back(0x01);
    size_t pos = 0;
    while (pos < raw.size()) {
        size_t blk = raw.size() - pos;
        if (blk > 65535) blk = 65535;
        bool last = pos + blk == raw.size();
        z.push_back(last ? 1 : 0);
        z.push_back(static_cast<char>(blk & 0xFF));
        z.push_back(static_cast<char>(blk >> 8));
        z.push_back(static_cast<char>(~blk & 0xFF));
        z.push_back(static_cast<char>((~blk >> 8) & 0xFF));
        z.append(raw, pos, blk);
        pos += blk;
    }
    uint32_t a = 1, b = 0;
    for (unsigned char ch : raw) {
        a = (a + ch) % 65521;
        b = (b + a) % 65521;
    }
    put_u32(z, (b << 16) | a);

    std::string png("\x89PNG\r\n\x1a\n", 8);
    std::string ihdr;
    put_u32(ihdr, static_cast<uint32_t>(w));
    put_u32(ihdr, static_cast<uint32_t>(h));
    ihdr.push_back(8);   // bit depth
    ihdr.push_back(2);   // color type RGB
    ihdr.push_back(0);   // compression
    ihdr.push_back(0);   // filter
    ihdr.push_back(0);   // interlace
    chunk(png, "IHDR", ihdr);
    chunk(png, "IDAT", z);
    chunk(png, "IEND", "");

    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    size_t written = fwrite(png.data(), 1, png.size(), f);
    fclose(f);
    return written == png.size() ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Event queue (the reference's 512-slot ring, src/gpu_and_windowing.c:19-22,
// fed by a reader thread instead of GLFW callbacks)
// ---------------------------------------------------------------------------

enum {
    EVENT_EMPTY = 0, EVENT_CLOSE = 1, EVENT_PRESS_SPACE = 2, EVENT_PRESS_ESC = 3,
    EVENT_PRESS_W = 4, EVENT_PRESS_A = 5, EVENT_PRESS_S = 6, EVENT_PRESS_D = 7,
    EVENT_MOVE_MOUSE = 8,  // coordinates fetched lazily via rt_mouse_pos,
                           // like the reference's pop_event out-params
                           // (src/gpu_and_windowing.c:243-244)
    EVENT_LOOK_UP = 20, EVENT_LOOK_DOWN = 21, EVENT_LOOK_LEFT = 22, EVENT_LOOK_RIGHT = 23,
};

namespace {
constexpr int MAX_EVENTS = 512;  // src/gpu_and_windowing.c:19
int event_queue[MAX_EVENTS];
int event_head = 0;
int event_size = 0;
std::mutex event_mutex;
std::thread reader_thread;
std::atomic<bool> reader_stop{false};
int reader_fd = -1;

double mouse_x = 0.0, mouse_y = 0.0;  // latest SGR mouse position (cells)

void push_event(int ev) {
    std::lock_guard<std::mutex> lock(event_mutex);
    if (event_size == MAX_EVENTS) return;  // drop, like src/gpu_and_windowing.c:222-227
    event_queue[(event_head + event_size) % MAX_EVENTS] = ev;
    event_size++;
}

// Full CSI sequence ending at buf[i+1..]: returns length consumed past the
// ESC (0 if incomplete). Decodes SGR-1006 mouse reports ("\x1b[<b;x;yM/m",
// the terminal equivalent of GLFW's cursor callback) into mouse state +
// EVENT_MOVE_MOUSE, and plain arrows into look events.
size_t parse_csi(const char* s, size_t len) {
    // s points at '['; parameter bytes 0x30-0x3F, intermediates 0x20-0x2F,
    // one final byte 0x40-0x7E
    size_t j = 1;
    while (j < len && ((s[j] >= 0x30 && s[j] <= 0x3F) || (s[j] >= 0x20 && s[j] <= 0x2F)))
        j++;
    if (j >= len) return 0;  // incomplete: wait for more bytes
    char fin = s[j];
    if (j == 1) {  // no parameters: plain arrows / X10 mouse
        if (fin == 'M') {
            // X10 mouse report: ESC [ M + 3 raw payload bytes (button+32,
            // x+32, y+32) — what ?1003h yields on terminals without
            // SGR-1006. The payload is printable bytes and must be
            // consumed here, never left for the key switch (it would
            // inject moves or quit while the mouse moves).
            if (len < j + 4) return 0;  // payload split across reads
            int b = static_cast<unsigned char>(s[j + 1]) - 32;
            if (b & 32) {  // motion report
                {
                    std::lock_guard<std::mutex> lock(event_mutex);
                    mouse_x = static_cast<double>(
                        static_cast<unsigned char>(s[j + 2]) - 32);
                    mouse_y = static_cast<double>(
                        static_cast<unsigned char>(s[j + 3]) - 32);
                }
                push_event(EVENT_MOVE_MOUSE);
            }
            return j + 4;
        }
        switch (fin) {
            case 'A': push_event(EVENT_LOOK_UP); break;
            case 'B': push_event(EVENT_LOOK_DOWN); break;
            case 'C': push_event(EVENT_LOOK_RIGHT); break;
            case 'D': push_event(EVENT_LOOK_LEFT); break;
            default: break;
        }
        return j + 1;
    }
    if (s[1] == '<' && (fin == 'M' || fin == 'm')) {
        int vals[3] = {0, 0, 0};
        int vi = 0;
        for (size_t k = 2; k < j && vi < 3; k++) {
            if (s[k] == ';') { vi++; continue; }
            if (s[k] >= '0' && s[k] <= '9') vals[vi] = vals[vi] * 10 + (s[k] - '0');
        }
        int b = vals[0];
        if (b & 32) {  // motion report (any-motion / drag tracking)
            {
                std::lock_guard<std::mutex> lock(event_mutex);
                mouse_x = static_cast<double>(vals[1]);
                mouse_y = static_cast<double>(vals[2]);
            }
            push_event(EVENT_MOVE_MOUSE);
        }
    }
    return j + 1;  // any other parameterized CSI (F5+, modifiers): swallow
}

void reader_main() {
    // Escape sequences can split across reads (arrow-key autorepeat through
    // fixed-size reads): keep a carry buffer so a trailing partial
    // "\x1b"/"\x1b[" waits for its continuation instead of being misread as
    // a bare ESC (= quit).
    char buf[72];
    size_t pending = 0;
    int esc_age = 0;  // idle reads a lone pending ESC has waited
    while (!reader_stop.load(std::memory_order_relaxed)) {
        ssize_t k = read(reader_fd, buf + pending, sizeof buf - pending);
        if (k <= 0) {
            if (k == 0) { push_event(EVENT_CLOSE); break; }
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                if (pending == 1 && buf[0] == '\x1b' && ++esc_age >= 4) {
                    push_event(EVENT_PRESS_ESC);  // a real lone ESC press
                    pending = 0;
                    esc_age = 0;
                }
                usleep(5000);
                continue;
            }
            break;
        }
        esc_age = 0;
        k += static_cast<ssize_t>(pending);
        pending = 0;
        for (ssize_t i = 0; i < k; i++) {
            char ch = buf[i];
            if (ch == '\x1b' &&
                (i + 1 >= k || (buf[i + 1] == 'O' && i + 2 >= k))) {
                // partial ESC / SS3 at buffer end: carry to the next read
                // (a split "\x1bO" must not fall through as a bare ESC)
                pending = static_cast<size_t>(k - i);
                memmove(buf, buf + i, pending);
                break;
            }
            if (ch == '\x1b' && buf[i + 1] == '[') {
                size_t used = parse_csi(buf + i + 1, static_cast<size_t>(k - i - 1));
                if (used == 0) {
                    // incomplete CSI: carry unless it can never fit the buffer
                    size_t rest = static_cast<size_t>(k - i);
                    if (rest < sizeof buf) {
                        pending = rest;
                        memmove(buf, buf + i, pending);
                    }
                    break;
                }
                i += static_cast<ssize_t>(used);  // +1 more from the loop
                continue;
            }
            if (ch == '\x1b' && buf[i + 1] == 'O' && i + 2 < k) {
                i += 2;  // SS3 (F1-F4): swallow
                continue;
            }
            switch (tolower(static_cast<unsigned char>(ch))) {
                case 'w': push_event(EVENT_PRESS_W); break;
                case 'a': push_event(EVENT_PRESS_A); break;
                case 's': push_event(EVENT_PRESS_S); break;
                case 'd': push_event(EVENT_PRESS_D); break;
                case ' ': push_event(EVENT_PRESS_SPACE); break;
                case 'q': case '\x1b': push_event(EVENT_PRESS_ESC); break;
                case 'i': push_event(EVENT_LOOK_UP); break;
                case 'k': push_event(EVENT_LOOK_DOWN); break;
                case 'j': push_event(EVENT_LOOK_LEFT); break;
                case 'l': push_event(EVENT_LOOK_RIGHT); break;
            }
        }
    }
}
}  // namespace

// Start the reader thread on fd (non-blocking). Returns 0 on success.
int rt_events_start(int fd) {
    if (reader_thread.joinable()) return -1;
    reader_fd = fd;
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    reader_stop.store(false);
    reader_thread = std::thread(reader_main);
    return 0;
}

void rt_events_stop() {
    reader_stop.store(true);
    if (reader_thread.joinable()) reader_thread.join();
    {
        std::lock_guard<std::mutex> lock(event_mutex);
        event_head = 0;
        event_size = 0;
    }
}

// pop_event (src/gpu_and_windowing.c:231-246): returns EVENT_EMPTY when drained.
int rt_events_pop() {
    std::lock_guard<std::mutex> lock(event_mutex);
    if (event_size == 0) return EVENT_EMPTY;
    int ev = event_queue[event_head];
    event_head = (event_head + 1) % MAX_EVENTS;
    event_size--;
    return ev;
}

// Test hook: inject an event as if typed.
void rt_events_inject(int ev) { push_event(ev); }

// Latest SGR mouse position, fetched lazily after EVENT_MOVE_MOUSE — the
// reference's pop_event out-params (src/gpu_and_windowing.c:243-244).
void rt_mouse_pos(double* x, double* y) {
    std::lock_guard<std::mutex> lock(event_mutex);
    *x = mouse_x;
    *y = mouse_y;
}

// Test hook: feed raw bytes through the same CSI parser the reader uses.
void rt_events_parse(const char* bytes, long len) {
    for (long i = 0; i < len; i++) {
        char ch = bytes[i];
        if (ch == '\x1b' && i + 1 < len && bytes[i + 1] == '[') {
            size_t used = parse_csi(bytes + i + 1, static_cast<size_t>(len - i - 1));
            if (used == 0) return;
            i += static_cast<long>(used);
            continue;
        }
        switch (tolower(static_cast<unsigned char>(ch))) {
            case 'w': push_event(EVENT_PRESS_W); break;
            case 'a': push_event(EVENT_PRESS_A); break;
            case 's': push_event(EVENT_PRESS_S); break;
            case 'd': push_event(EVENT_PRESS_D); break;
            case ' ': push_event(EVENT_PRESS_SPACE); break;
            case 'q': case '\x1b': push_event(EVENT_PRESS_ESC); break;
            case 'i': push_event(EVENT_LOOK_UP); break;
            case 'k': push_event(EVENT_LOOK_DOWN); break;
            case 'j': push_event(EVENT_LOOK_LEFT); break;
            case 'l': push_event(EVENT_LOOK_RIGHT); break;
        }
    }
}

}  // extern "C"
