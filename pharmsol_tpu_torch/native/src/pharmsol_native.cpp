// pharmsol-tpu native runtime: columnar Pmetrics CSV parser.
//
// The reference's data layer is native Rust (src/data/parser/pmetrics.rs);
// this is the TPU rebuild's native-IO equivalent: a single-pass CSV
// tokenizer that emits numeric columns and interned string tables, consumed
// zero-copy-ish by Python via ctypes. Grouping/padding into device arrays
// happens vectorized in numpy on top of these columns.
//
// Semantics match the Python parser (data/pmetrics.py):
//   - headers lowercased; '#' comment lines skipped; leading '#' stripped
//     off the first header cell
//   - canonical columns: id,time,evid,dose,dur,addl,ii,input,out,outeq,
//     cens,c0..c3; all other columns are covariates
//   - empty / '.' / 'na' / 'nan' cells are missing (NaN)
//   - OUT == -99 is treated as missing by the Python layer (kept raw here)
//
// Build: g++ -O3 -shared -fPIC -o libpharmsol_native.so pharmsol_native.cpp

#include <cctype>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct StringTable {
    std::vector<std::string> values;
    std::unordered_map<std::string, long> index;

    long intern(const std::string& s) {
        auto it = index.find(s);
        if (it != index.end()) return it->second;
        long id = static_cast<long>(values.size());
        values.push_back(s);
        index.emplace(s, id);
        return id;
    }
};

struct Parsed {
    // numeric columns (NaN = missing)
    std::unordered_map<std::string, std::vector<double>> numeric;
    // interned string columns (-1 = missing)
    std::unordered_map<std::string, std::vector<long>> interned;
    StringTable ids;
    StringTable inputs;
    StringTable outeqs;
    std::vector<std::string> cov_names;                  // covariate column names
    std::vector<std::vector<double>> cov_columns;        // parallel to cov_names
    long nrows = 0;
    std::string error;
};

bool is_missing(const std::string& cell) {
    if (cell.empty()) return true;
    std::string t;
    t.reserve(cell.size());
    for (char c : cell) {
        if (!isspace(static_cast<unsigned char>(c))) t.push_back(static_cast<char>(tolower(c)));
    }
    return t.empty() || t == "." || t == "na" || t == "nan";
}

double parse_double(const std::string& cell, bool& ok) {
    if (is_missing(cell)) {
        ok = true;
        return NAN;
    }
    char* end = nullptr;
    double v = strtod(cell.c_str(), &end);
    while (end && *end && isspace(static_cast<unsigned char>(*end))) ++end;
    ok = end && *end == '\0';
    return v;
}

std::string trim(const std::string& s) {
    size_t a = 0, b = s.size();
    while (a < b && isspace(static_cast<unsigned char>(s[a]))) ++a;
    while (b > a && isspace(static_cast<unsigned char>(s[b - 1]))) --b;
    return s.substr(a, b - a);
}

std::string lower(std::string s) {
    for (char& c : s) c = static_cast<char>(tolower(static_cast<unsigned char>(c)));
    return s;
}

// Split one CSV record (no embedded-quote handling beyond simple quotes).
void split_record(const std::string& line, std::vector<std::string>& out) {
    out.clear();
    std::string cur;
    bool quoted = false;
    for (char c : line) {
        if (c == '"') {
            quoted = !quoted;
        } else if (c == ',' && !quoted) {
            out.push_back(trim(cur));
            cur.clear();
        } else {
            cur.push_back(c);
        }
    }
    out.push_back(trim(cur));
}

const char* kNumericCols[] = {"time", "dose", "dur", "addl", "ii",
                              "out", "c0", "c1", "c2", "c3", "evid", "cens"};

}  // namespace

extern "C" {

Parsed* psn_parse(const char* text, long len) {
    auto* p = new Parsed();
    std::string src(text, static_cast<size_t>(len));

    std::vector<std::string> header;
    std::vector<long> cov_col_idx;   // physical column -> cov slot (-1 none)
    std::vector<std::string> cells;

    for (const char* col : kNumericCols) p->numeric[col] = {};
    p->interned["id"] = {};
    p->interned["input"] = {};
    p->interned["outeq"] = {};

    size_t pos = 0;
    bool have_header = false;
    std::unordered_map<std::string, long> col_of;

    while (pos <= src.size()) {
        size_t eol = src.find('\n', pos);
        std::string line = src.substr(pos, eol == std::string::npos ? std::string::npos
                                                                    : eol - pos);
        pos = (eol == std::string::npos) ? src.size() + 1 : eol + 1;
        std::string stripped = trim(line);
        if (stripped.empty()) continue;
        if (!have_header) {
            // '#' may prefix the header line itself (Pmetrics writes "#ID");
            // later '#' lines are comments
            split_record(stripped, header);
            for (auto& h : header) h = lower(trim(h));
            if (!header.empty() && !header[0].empty() && header[0][0] == '#') {
                header[0] = header[0].substr(header[0].find_first_not_of('#'));
            }
            for (size_t i = 0; i < header.size(); ++i) {
                col_of[header[i]] = static_cast<long>(i);
            }
            static const char* canonical[] = {"id", "time", "evid", "dose", "dur",
                                              "addl", "ii", "input", "out", "outeq",
                                              "cens", "c0", "c1", "c2", "c3"};
            cov_col_idx.assign(header.size(), -1);
            for (size_t i = 0; i < header.size(); ++i) {
                bool is_canonical = false;
                for (const char* c : canonical) {
                    if (header[i] == c) { is_canonical = true; break; }
                }
                if (!is_canonical) {
                    cov_col_idx[i] = static_cast<long>(p->cov_names.size());
                    p->cov_names.push_back(header[i]);
                    p->cov_columns.emplace_back();
                }
            }
            if (col_of.find("id") == col_of.end() || col_of.find("time") == col_of.end() ||
                col_of.find("evid") == col_of.end()) {
                p->error = "Pmetrics file must have ID, TIME, EVID columns";
                return p;
            }
            have_header = true;
            continue;
        }
        if (stripped[0] == '#') continue;
        split_record(stripped, cells);

        auto cell = [&](const char* name) -> std::string {
            auto it = col_of.find(name);
            if (it == col_of.end()) return "";
            size_t i = static_cast<size_t>(it->second);
            return i < cells.size() ? cells[i] : "";
        };

        // id / input / outeq interned strings
        std::string id = cell("id");
        if (is_missing(id)) {
            p->error = "row missing ID at row " + std::to_string(p->nrows + 1);
            return p;
        }
        p->interned["id"].push_back(p->ids.intern(id));
        std::string input = cell("input");
        p->interned["input"].push_back(is_missing(input) ? -1 : p->inputs.intern(input));
        std::string outeq = cell("outeq");
        p->interned["outeq"].push_back(is_missing(outeq) ? -1 : p->outeqs.intern(outeq));

        for (const char* col : kNumericCols) {
            std::string c = cell(col);
            // CENS accepts bloq/aloq/none words
            if (strcmp(col, "cens") == 0 && !is_missing(c)) {
                std::string lc = lower(c);
                if (lc == "bloq") c = "1";
                else if (lc == "aloq") c = "-1";
                else if (lc == "none") c = "0";
            }
            bool ok = true;
            double v = parse_double(c, ok);
            if (!ok) {
                p->error = "could not parse number `" + c + "` in column " + col +
                           " at data row " + std::to_string(p->nrows + 1);
                return p;
            }
            p->numeric[col].push_back(v);
        }
        for (size_t i = 0; i < cov_col_idx.size(); ++i) {
            if (cov_col_idx[i] < 0) continue;
            bool ok = true;
            double v = (i < cells.size()) ? parse_double(cells[i], ok) : NAN;
            if (!ok) {
                p->error = "could not parse covariate `" + header[i] + "` at data row " +
                           std::to_string(p->nrows + 1);
                return p;
            }
            p->cov_columns[static_cast<size_t>(cov_col_idx[i])].push_back(v);
        }
        p->nrows += 1;
    }
    if (!have_header) p->error = "empty Pmetrics file";
    return p;
}

const char* psn_error(Parsed* p) { return p->error.empty() ? nullptr : p->error.c_str(); }

long psn_nrows(Parsed* p) { return p->nrows; }

long psn_ncov(Parsed* p) { return static_cast<long>(p->cov_names.size()); }

int psn_numeric(Parsed* p, const char* name, double* out) {
    auto it = p->numeric.find(name);
    if (it == p->numeric.end()) return -1;
    memcpy(out, it->second.data(), it->second.size() * sizeof(double));
    return 0;
}

int psn_interned(Parsed* p, const char* name, long* out) {
    auto it = p->interned.find(name);
    if (it == p->interned.end()) return -1;
    memcpy(out, it->second.data(), it->second.size() * sizeof(long));
    return 0;
}

int psn_cov_column(Parsed* p, long idx, double* out) {
    if (idx < 0 || idx >= static_cast<long>(p->cov_columns.size())) return -1;
    const auto& col = p->cov_columns[static_cast<size_t>(idx)];
    memcpy(out, col.data(), col.size() * sizeof(double));
    return 0;
}

static StringTable* table_of(Parsed* p, const char* which) {
    if (strcmp(which, "id") == 0) return &p->ids;
    if (strcmp(which, "input") == 0) return &p->inputs;
    if (strcmp(which, "outeq") == 0) return &p->outeqs;
    return nullptr;
}

long psn_table_len(Parsed* p, const char* which) {
    StringTable* t = table_of(p, which);
    return t ? static_cast<long>(t->values.size()) : -1;
}

long psn_table_get(Parsed* p, const char* which, long idx, char* buf, long buflen) {
    StringTable* t = table_of(p, which);
    if (!t || idx < 0 || idx >= static_cast<long>(t->values.size())) return -1;
    const std::string& s = t->values[static_cast<size_t>(idx)];
    long n = static_cast<long>(s.size());
    if (buf && buflen > 0) {
        long copy = n < buflen - 1 ? n : buflen - 1;
        memcpy(buf, s.data(), static_cast<size_t>(copy));
        buf[copy] = '\0';
    }
    return n;
}

long psn_cov_name(Parsed* p, long idx, char* buf, long buflen) {
    if (idx < 0 || idx >= static_cast<long>(p->cov_names.size())) return -1;
    const std::string& s = p->cov_names[static_cast<size_t>(idx)];
    long n = static_cast<long>(s.size());
    if (buf && buflen > 0) {
        long copy = n < buflen - 1 ? n : buflen - 1;
        memcpy(buf, s.data(), static_cast<size_t>(copy));
        buf[copy] = '\0';
    }
    return n;
}

void psn_free(Parsed* p) { delete p; }

const char* psn_version() { return "pharmsol-tpu-native 0.1.0"; }

}  // extern "C"
