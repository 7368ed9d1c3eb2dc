// Multi-conformer xyz parser: the host-side hot loop of `io.read_xyz`.
//
// Plain C ABI, loaded through ctypes (`csrc.load_xyzparse`), built by g++ at
// first use.  Multi-megabyte trajectory files parse far faster than through
// the Python line loop, which `io.read_xyz` keeps as its other route.
//
// Contract (see io.py::_native_read_xyz):
//   parse_xyz(text, n, max_frames, out_counts, out_znums, out_coords,
//             max_atoms_cap) -> frames parsed (negative on error)
// Frames are written consecutively; each frame i has out_counts[i] atoms,
// species in out_znums[i*max_atoms_cap + j] and coordinates in
// out_coords[(i*max_atoms_cap + j)*3 + k].  The comment line is skipped:
// cell and pbc are read in Python.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// Minimal symbol -> atomic number table (H..Og), index by 2-char key.
struct Sym {
    const char* s;
    int z;
};
constexpr Sym kSymbols[] = {
    {"H", 1},   {"He", 2},  {"Li", 3},  {"Be", 4},  {"B", 5},   {"C", 6},
    {"N", 7},   {"O", 8},   {"F", 9},   {"Ne", 10}, {"Na", 11}, {"Mg", 12},
    {"Al", 13}, {"Si", 14}, {"P", 15},  {"S", 16},  {"Cl", 17}, {"Ar", 18},
    {"K", 19},  {"Ca", 20}, {"Sc", 21}, {"Ti", 22}, {"V", 23},  {"Cr", 24},
    {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28}, {"Cu", 29}, {"Zn", 30},
    {"Ga", 31}, {"Ge", 32}, {"As", 33}, {"Se", 34}, {"Br", 35}, {"Kr", 36},
    {"Rb", 37}, {"Sr", 38}, {"Y", 39},  {"Zr", 40}, {"Nb", 41}, {"Mo", 42},
    {"Tc", 43}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47}, {"Cd", 48},
    {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"I", 53},  {"Xe", 54},
    {"Cs", 55}, {"Ba", 56}, {"La", 57}, {"Ce", 58}, {"Pr", 59}, {"Nd", 60},
    {"Pm", 61}, {"Sm", 62}, {"Eu", 63}, {"Gd", 64}, {"Tb", 65}, {"Dy", 66},
    {"Ho", 67}, {"Er", 68}, {"Tm", 69}, {"Yb", 70}, {"Lu", 71}, {"Hf", 72},
    {"Ta", 73}, {"W", 74},  {"Re", 75}, {"Os", 76}, {"Ir", 77}, {"Pt", 78},
    {"Au", 79}, {"Hg", 80}, {"Tl", 81}, {"Pb", 82}, {"Bi", 83}, {"Po", 84},
    {"At", 85}, {"Rn", 86}, {"Fr", 87}, {"Ra", 88}, {"Ac", 89}, {"Th", 90},
    {"Pa", 91}, {"U", 92},  {"Np", 93}, {"Pu", 94}, {"Am", 95}, {"Cm", 96},
    {"Bk", 97}, {"Cf", 98}, {"Es", 99}, {"Fm", 100},
};

int symbol_to_z(const char* tok, int len) {
    if (len <= 0 || len > 3) return -1;
    // numeric label (already an atomic number)
    bool numeric = true;
    for (int i = 0; i < len; ++i) {
        if (!std::isdigit(static_cast<unsigned char>(tok[i]))) {
            numeric = false;
            break;
        }
    }
    if (numeric) return std::atoi(tok);
    for (const auto& e : kSymbols) {
        if (static_cast<int>(std::strlen(e.s)) == len &&
            std::strncmp(e.s, tok, len) == 0) {
            return e.z;
        }
    }
    return -1;
}

const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// Returns number of frames parsed, or -(byte offset) - 1 on parse error.
long parse_xyz(const char* text, long n, long max_frames, int* out_counts,
               int* out_znums, float* out_coords, long max_atoms_cap) {
    const char* p = text;
    const char* end = text + n;
    long frame = 0;
    while (p < end && frame < max_frames) {
        p = skip_ws(p, end);
        if (p >= end || *p == '\n') {  // blank line
            if (p < end) ++p;
            continue;
        }
        char* after = nullptr;
        long natoms = std::strtol(p, &after, 10);
        if (after == p || natoms <= 0 || natoms > max_atoms_cap)
            return -(p - text) - 1;
        p = next_line(after, end);
        p = next_line(p, end);  // comment line
        for (long a = 0; a < natoms; ++a) {
            p = skip_ws(p, end);
            const char* tok = p;
            while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
            int z = symbol_to_z(tok, static_cast<int>(p - tok));
            if (z < 0) return -(tok - text) - 1;
            out_znums[frame * max_atoms_cap + a] = z;
            for (int k = 0; k < 3; ++k) {
                p = skip_ws(p, end);
                char* q = nullptr;
                double v = std::strtod(p, &q);
                if (q == p) return -(p - text) - 1;
                out_coords[(frame * max_atoms_cap + a) * 3 + k] =
                    static_cast<float>(v);
                p = q;
            }
            p = next_line(p, end);
        }
        out_counts[frame] = static_cast<int>(natoms);
        ++frame;
    }
    return frame;
}

}  // extern "C"
