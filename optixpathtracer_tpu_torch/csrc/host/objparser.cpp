// Fast Wavefront OBJ tokenizer — the native scene-ingest path
// (tinyobjloader's role in the reference, Model.cpp:137-212).
//
// Scope: the hot, allocation-heavy part of OBJ parsing — reading vertices,
// normals, texcoords and faces (with negative-index resolution and fan
// triangulation) grouped by (object/group, usemtl) runs. Material files and
// texture decode stay in Python (cold path). Exposed as a C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libobjparser.so objparser.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tri {
    int32_t v[3];
    int32_t vt[3];
    int32_t vn[3];
    int32_t group;
};

struct ObjData {
    std::vector<float> positions;  // 3 per vertex
    std::vector<float> normals;
    std::vector<float> texcoords;  // 2 per vertex
    std::vector<Tri> tris;
    std::vector<std::string> group_names;  // "shape\x1fmaterial"
};

// skip spaces/tabs
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
    char* q;
    *out = strtof(p, &q);
    (void)end;
    return q;
}

// parse one face corner "v", "v/vt", "v//vn", "v/vt/vn"; 1-based, negatives
// count from the current end (OBJ spec; the reference's loader resolves the
// same way via tinyobj)
inline const char* parse_corner(const char* p, const char* end, int64_t nv,
                                int64_t nt, int64_t nn, int32_t* v,
                                int32_t* vt, int32_t* vn) {
    char* q;
    long a = strtol(p, &q, 10);
    *v = (int32_t)(a > 0 ? a - 1 : (a < 0 ? nv + a : -1));
    *vt = -1;
    *vn = -1;
    p = q;
    if (p < end && *p == '/') {
        ++p;
        if (p < end && *p != '/') {
            long b = strtol(p, &q, 10);
            *vt = (int32_t)(b > 0 ? b - 1 : (b < 0 ? nt + b : -1));
            p = q;
        }
        if (p < end && *p == '/') {
            ++p;
            long c = strtol(p, &q, 10);
            *vn = (int32_t)(c > 0 ? c - 1 : (c < 0 ? nn + c : -1));
            p = q;
        }
    }
    return p;
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(size);
    if (fread(buf.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    auto* d = new ObjData();
    d->positions.reserve(1 << 16);
    std::string shape = "default";
    std::string material = "";
    int32_t group = -1;
    auto group_key = [&]() {
        std::string key = shape + '\x1f' + material;
        for (size_t i = 0; i < d->group_names.size(); ++i)
            if (d->group_names[i] == key) return (int32_t)i;
        d->group_names.push_back(key);
        return (int32_t)(d->group_names.size() - 1);
    };

    const char* p = buf.data();
    const char* end = p + buf.size();
    std::vector<int32_t> face_v, face_vt, face_vn;
    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
            float x, y, z;
            p = parse_float(p + 2, end, &x);
            p = parse_float(p, end, &y);
            p = parse_float(p, end, &z);
            d->positions.push_back(x);
            d->positions.push_back(y);
            d->positions.push_back(z);
        } else if (p[0] == 'v' && p + 1 < end && p[1] == 'n' && p[2] == ' ') {
            float x, y, z;
            p = parse_float(p + 3, end, &x);
            p = parse_float(p, end, &y);
            p = parse_float(p, end, &z);
            d->normals.push_back(x);
            d->normals.push_back(y);
            d->normals.push_back(z);
        } else if (p[0] == 'v' && p + 1 < end && p[1] == 't' && p[2] == ' ') {
            float u, v;
            p = parse_float(p + 3, end, &u);
            p = parse_float(p, end, &v);
            d->texcoords.push_back(u);
            d->texcoords.push_back(v);
        } else if (p[0] == 'f' && p + 1 < end && p[1] == ' ') {
            if (group < 0) group = group_key();
            p += 2;
            face_v.clear();
            face_vt.clear();
            face_vn.clear();
            int64_t nv = (int64_t)d->positions.size() / 3;
            int64_t nt = (int64_t)d->texcoords.size() / 2;
            int64_t nn = (int64_t)d->normals.size() / 3;
            while (true) {
                p = skip_ws(p, end);
                if (p >= end || *p == '\n' || *p == '#') break;
                int32_t v, vt, vn;
                p = parse_corner(p, end, nv, nt, nn, &v, &vt, &vn);
                face_v.push_back(v);
                face_vt.push_back(vt);
                face_vn.push_back(vn);
            }
            // fan triangulation (tinyobj triangulate=true equivalent)
            for (size_t k = 1; k + 1 < face_v.size(); ++k) {
                Tri t;
                t.v[0] = face_v[0];
                t.v[1] = face_v[k];
                t.v[2] = face_v[k + 1];
                t.vt[0] = face_vt[0];
                t.vt[1] = face_vt[k];
                t.vt[2] = face_vt[k + 1];
                t.vn[0] = face_vn[0];
                t.vn[1] = face_vn[k];
                t.vn[2] = face_vn[k + 1];
                t.group = group;
                d->tris.push_back(t);
            }
        } else if ((p[0] == 'o' || p[0] == 'g') && p + 1 < end && p[1] == ' ') {
            const char* q = next_line(p, end);
            const char* s = skip_ws(p + 2, end);
            const char* e = q;
            while (e > s && (e[-1] == '\n' || e[-1] == '\r' || e[-1] == ' ')) --e;
            shape = (e > s) ? std::string(s, e - s) : std::string("default");
            group = -1;
            p = q;
            continue;
        } else if (!strncmp(p, "usemtl", 6)) {
            const char* q = next_line(p, end);
            const char* s = skip_ws(p + 6, end);
            const char* e = q;
            while (e > s && (e[-1] == '\n' || e[-1] == '\r' || e[-1] == ' ')) --e;
            material = (e > s) ? std::string(s, e - s) : std::string("");
            group = -1;
            p = q;
            continue;
        }
        p = next_line(p, end);
    }
    return d;
}

void obj_counts(void* handle, int64_t* out5) {
    auto* d = (ObjData*)handle;
    out5[0] = (int64_t)d->positions.size() / 3;
    out5[1] = (int64_t)d->normals.size() / 3;
    out5[2] = (int64_t)d->texcoords.size() / 2;
    out5[3] = (int64_t)d->tris.size();
    out5[4] = (int64_t)d->group_names.size();
}

void obj_copy_positions(void* handle, float* out) {
    auto* d = (ObjData*)handle;
    memcpy(out, d->positions.data(), d->positions.size() * sizeof(float));
}

void obj_copy_normals(void* handle, float* out) {
    auto* d = (ObjData*)handle;
    memcpy(out, d->normals.data(), d->normals.size() * sizeof(float));
}

void obj_copy_texcoords(void* handle, float* out) {
    auto* d = (ObjData*)handle;
    memcpy(out, d->texcoords.data(), d->texcoords.size() * sizeof(float));
}

// out layout per tri: v0 v1 v2 vt0 vt1 vt2 vn0 vn1 vn2 group  (10 x int32)
void obj_copy_tris(void* handle, int32_t* out) {
    auto* d = (ObjData*)handle;
    for (size_t i = 0; i < d->tris.size(); ++i) {
        const Tri& t = d->tris[i];
        int32_t* o = out + i * 10;
        o[0] = t.v[0];
        o[1] = t.v[1];
        o[2] = t.v[2];
        o[3] = t.vt[0];
        o[4] = t.vt[1];
        o[5] = t.vt[2];
        o[6] = t.vn[0];
        o[7] = t.vn[1];
        o[8] = t.vn[2];
        o[9] = t.group;
    }
}

const char* obj_group_name(void* handle, int64_t i) {
    auto* d = (ObjData*)handle;
    if (i < 0 || (size_t)i >= d->group_names.size()) return "";
    return d->group_names[i].c_str();
}

void obj_free(void* handle) { delete (ObjData*)handle; }

}  // extern "C"
