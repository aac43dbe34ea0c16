// pkm_host: a standalone C++ host for pharmsol-tpu `.pkm` artifacts.
//
// The reference executes models on foreign hosts through WASM bundles
// (src/dsl/wasm_compile.rs:30-43 + browser-compile-bridge/); the TPU
// rebuild's `.pkm` artifact is plain JSON carrying the analyzed statement
// IR, and dsl/pure.py documents the evaluation contract ("any host that
// can parse JSON and evaluate arithmetic can run a pharmsol model"). This
// program PROVES that contract outside Python: it parses an artifact +
// a scenario with nothing but the C++ standard library and simulates all
// three model kinds with the same algorithms as the pure tier —
//
//   ode        fixed-step RK4 over the event timeline
//   analytical exact closed-form segment propagation (scaling-and-squaring
//              Taylor matrix exponential on the affine augmented system,
//              kernel inputs re-derived at each segment end)
//   sde        fixed-step Euler-Maruyama particle cloud (mean outputs;
//              zero-diffusion artifacts reproduce the deterministic tiers
//              bit-for-bit up to libm differences)
//
// Usage: pkm_host <model.pkm> <scenario.json>
// Scenario: {"params": [..], "boluses": [[t, amt, state_idx], ..],
//            "obs_times": [..],
//            "covariates": {"wt": {"fixed": false, "knots": [[t, v], ..]}},
//            "dt": 0.01, "nparticles": 16, "seed": 0}
// Output: one JSON array of per-observation output arrays on stdout.
//
// Parity is enforced by tests/test_pkm_host.py against dsl/pure.py and the
// jitted engine.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <random>
#include <sstream>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Minimal JSON DOM (objects keep insertion order; numbers are doubles).
// ---------------------------------------------------------------------------

struct Json;
using JsonPtr = std::shared_ptr<Json>;

struct Json {
    enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ } kind = NUL;
    bool b = false;
    double num = 0.0;
    std::string str;
    std::vector<JsonPtr> arr;
    std::vector<std::pair<std::string, JsonPtr>> obj;

    const JsonPtr get(const std::string& key) const {
        for (const auto& kv : obj)
            if (kv.first == key) return kv.second;
        return nullptr;
    }
    bool is_null() const { return kind == NUL; }
};

struct JsonParser {
    const char* p;
    const char* end;
    explicit JsonParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

    [[noreturn]] void fail(const std::string& what) {
        throw std::runtime_error("pkm_host JSON parse error: " + what);
    }
    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    }
    bool lit(const char* s) {
        size_t n = std::strlen(s);
        if (size_t(end - p) >= n && std::strncmp(p, s, n) == 0) { p += n; return true; }
        return false;
    }
    JsonPtr parse() {
        ws();
        JsonPtr v = value();
        ws();
        if (p != end) fail("trailing content");
        return v;
    }
    JsonPtr value() {
        ws();
        if (p >= end) fail("unexpected end");
        auto v = std::make_shared<Json>();
        char c = *p;
        if (c == '{') { object(*v); return v; }
        if (c == '[') { array(*v); return v; }
        if (c == '"') { v->kind = Json::STR; v->str = string(); return v; }
        if (lit("true")) { v->kind = Json::BOOL; v->b = true; return v; }
        if (lit("false")) { v->kind = Json::BOOL; v->b = false; return v; }
        if (lit("null")) { v->kind = Json::NUL; return v; }
        if (lit("NaN")) { v->kind = Json::NUM; v->num = NAN; return v; }
        if (lit("Infinity")) { v->kind = Json::NUM; v->num = INFINITY; return v; }
        if (lit("-Infinity")) { v->kind = Json::NUM; v->num = -INFINITY; return v; }
        // number
        char* q = nullptr;
        v->kind = Json::NUM;
        v->num = std::strtod(p, &q);
        if (q == p) fail(std::string("unexpected character `") + c + "`");
        p = q;
        return v;
    }
    std::string string() {
        if (*p != '"') fail("expected string");
        ++p;
        std::string out;
        while (p < end && *p != '"') {
            if (*p == '\\') {
                ++p;
                if (p >= end) fail("bad escape");
                char c = *p++;
                switch (c) {
                    case 'n': out += '\n'; break;
                    case 't': out += '\t'; break;
                    case 'r': out += '\r'; break;
                    case 'b': out += '\b'; break;
                    case 'f': out += '\f'; break;
                    case '"': out += '"'; break;
                    case '\\': out += '\\'; break;
                    case '/': out += '/'; break;
                    case 'u': {
                        if (end - p < 4) fail("bad \\u escape");
                        unsigned cp = 0;
                        for (int i = 0; i < 4; ++i) {
                            char h = *p++;
                            cp <<= 4;
                            if (h >= '0' && h <= '9') cp |= unsigned(h - '0');
                            else if (h >= 'a' && h <= 'f') cp |= unsigned(h - 'a' + 10);
                            else if (h >= 'A' && h <= 'F') cp |= unsigned(h - 'A' + 10);
                            else fail("bad \\u digit");
                        }
                        // UTF-8 encode (surrogate pairs unsupported; artifact
                        // identifiers are ASCII)
                        if (cp < 0x80) out += char(cp);
                        else if (cp < 0x800) {
                            out += char(0xC0 | (cp >> 6));
                            out += char(0x80 | (cp & 0x3F));
                        } else {
                            out += char(0xE0 | (cp >> 12));
                            out += char(0x80 | ((cp >> 6) & 0x3F));
                            out += char(0x80 | (cp & 0x3F));
                        }
                        break;
                    }
                    default: fail("bad escape");
                }
            } else {
                out += *p++;
            }
        }
        if (p >= end) fail("unterminated string");
        ++p;
        return out;
    }
    void array(Json& v) {
        v.kind = Json::ARR;
        ++p;  // [
        ws();
        if (p < end && *p == ']') { ++p; return; }
        while (true) {
            v.arr.push_back(value());
            ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == ']') { ++p; return; }
            fail("expected , or ] in array");
        }
    }
    void object(Json& v) {
        v.kind = Json::OBJ;
        ++p;  // {
        ws();
        if (p < end && *p == '}') { ++p; return; }
        while (true) {
            ws();
            std::string key = string();
            ws();
            if (p >= end || *p != ':') fail("expected : in object");
            ++p;
            v.obj.emplace_back(key, value());
            ws();
            if (p < end && *p == ',') { ++p; continue; }
            if (p < end && *p == '}') { ++p; return; }
            fail("expected , or } in object");
        }
    }
};

// ---------------------------------------------------------------------------
// Expression / statement IR (mirrors dsl/ast.py to_json layout).
// ---------------------------------------------------------------------------

struct Expr;
using ExprPtr = std::shared_ptr<Expr>;

struct Expr {
    std::string kind;  // number|bool|name|unary|binary|call|index
    std::string name;
    double value = 0.0;
    std::vector<ExprPtr> args;

    static ExprPtr from_json(const JsonPtr& j) {
        auto e = std::make_shared<Expr>();
        e->kind = j->arr.at(0)->str;
        if (e->kind == "number" || e->kind == "bool") {
            const Json& v = *j->arr.at(1);
            e->value = v.kind == Json::BOOL ? (v.b ? 1.0 : 0.0) : v.num;
            return e;
        }
        if (e->kind == "name") {
            e->name = j->arr.at(1)->str;
            return e;
        }
        e->name = j->arr.at(1)->str;
        for (const auto& a : j->arr.at(2)->arr) e->args.push_back(from_json(a));
        return e;
    }
};

struct Stmt;
using StmtPtr = std::shared_ptr<Stmt>;

struct Stmt {
    std::string kind;  // let|assign|if|for
    std::string target;
    std::string target_kind;  // name|call|index
    std::vector<std::string> target_args;
    std::string index_base;
    ExprPtr index_expr;
    ExprPtr value;
    ExprPtr condition;
    std::vector<StmtPtr> then_branch, else_branch;
    std::string binding;
    ExprPtr range_start, range_end;
    std::vector<StmtPtr> body;

    static StmtPtr from_json(const JsonPtr& j) {
        auto s = std::make_shared<Stmt>();
        s->kind = j->get("kind")->str;
        if (s->kind == "let" || s->kind == "assign") {
            s->target = j->get("target")->str;
            s->target_kind = j->get("target_kind")->str;
            if (auto ta = j->get("target_args"))
                for (const auto& a : ta->arr) s->target_args.push_back(a->str);
            if (auto ib = j->get("index_base"); ib && !ib->is_null())
                s->index_base = ib->str;
            if (auto ix = j->get("index"); ix && !ix->is_null())
                s->index_expr = Expr::from_json(ix);
            if (auto v = j->get("value"); v && !v->is_null())
                s->value = Expr::from_json(v);
            return s;
        }
        if (s->kind == "if") {
            s->condition = Expr::from_json(j->get("condition"));
            for (const auto& t : j->get("then")->arr) s->then_branch.push_back(from_json(t));
            for (const auto& t : j->get("else")->arr) s->else_branch.push_back(from_json(t));
            return s;
        }
        s->binding = j->get("binding")->str;
        s->range_start = Expr::from_json(j->get("start"));
        s->range_end = Expr::from_json(j->get("end"));
        for (const auto& t : j->get("body")->arr) s->body.push_back(from_json(t));
        return s;
    }
};

using Env = std::unordered_map<std::string, double>;

[[noreturn]] static void runtime_fail(const std::string& what) {
    throw std::runtime_error("pkm_host runtime error: " + what);
}

static double eval_expr(const Expr& e, Env& env) {
    if (e.kind == "number" || e.kind == "bool") return e.value;
    if (e.kind == "name") {
        auto it = env.find(e.name);
        if (it == env.end()) runtime_fail("unbound name `" + e.name + "`");
        return it->second;
    }
    if (e.kind == "unary") {
        double v = eval_expr(*e.args[0], env);
        if (e.name == "-") return -v;
        if (e.name == "+") return v;
        return v != 0.0 ? 0.0 : 1.0;  // !
    }
    if (e.kind == "binary") {
        double a = eval_expr(*e.args[0], env);
        // short-circuit like Python's and/or on already-evaluated floats is
        // value-identical for && / || since operands are plain numbers
        double b = eval_expr(*e.args[1], env);
        const std::string& op = e.name;
        if (op == "+") return a + b;
        if (op == "-") return a - b;
        if (op == "*") return a * b;
        if (op == "/") return a / b;
        if (op == "^") return std::pow(a, b);
        if (op == "==") return a == b ? 1.0 : 0.0;
        if (op == "!=") return a != b ? 1.0 : 0.0;
        if (op == "<") return a < b ? 1.0 : 0.0;
        if (op == "<=") return a <= b ? 1.0 : 0.0;
        if (op == ">") return a > b ? 1.0 : 0.0;
        if (op == ">=") return a >= b ? 1.0 : 0.0;
        if (op == "&&") return (a != 0.0 && b != 0.0) ? 1.0 : 0.0;
        if (op == "||") return (a != 0.0 || b != 0.0) ? 1.0 : 0.0;
        runtime_fail("unknown operator `" + op + "`");
    }
    if (e.kind == "call") {
        const std::string& f = e.name;
        std::vector<double> a;
        a.reserve(e.args.size());
        for (const auto& x : e.args) a.push_back(eval_expr(*x, env));
        if (f == "abs") return std::fabs(a.at(0));
        if (f == "min") { double m = a.at(0); for (double v : a) m = std::min(m, v); return m; }
        if (f == "max") { double m = a.at(0); for (double v : a) m = std::max(m, v); return m; }
        if (f == "floor") return std::floor(a.at(0));
        if (f == "ceil") return std::ceil(a.at(0));
        if (f == "exp") return std::exp(a.at(0));
        if (f == "ln" || f == "log") return std::log(a.at(0));
        if (f == "log10") return std::log10(a.at(0));
        if (f == "log2") return std::log2(a.at(0));
        if (f == "pow") return std::pow(a.at(0), a.at(1));
        // Python round() is round-half-even; nearbyint honors the default
        // FE_TONEAREST mode which is exactly that
        if (f == "round") return std::nearbyint(a.at(0));
        if (f == "sin") return std::sin(a.at(0));
        if (f == "cos") return std::cos(a.at(0));
        if (f == "tan") return std::tan(a.at(0));
        if (f == "sqrt") return std::sqrt(a.at(0));
        runtime_fail("unknown function `" + f + "`");
    }
    if (e.kind == "index") {
        const Expr& base = *e.args[0];
        long i = long(eval_expr(*e.args[1], env));
        std::string key = base.name + "[" + std::to_string(i) + "]";
        auto it = env.find(key);
        if (it == env.end()) runtime_fail("unbound name `" + key + "`");
        return it->second;
    }
    runtime_fail("unsupported expression `" + e.kind + "`");
}

static void eval_stmts(const std::vector<StmtPtr>& stmts, Env& env) {
    for (const auto& sp : stmts) {
        const Stmt& s = *sp;
        if (s.kind == "let" || s.kind == "assign") {
            if (s.kind == "assign" && s.target_kind == "call") {
                double v = eval_expr(*s.value, env);
                for (const auto& a : s.target_args) env[s.target + ":" + a] = v;
            } else if (s.kind == "assign" && s.target_kind == "index") {
                long i = long(eval_expr(*s.index_expr, env));
                env[s.target + ":" + s.index_base + "[" + std::to_string(i) + "]"] =
                    eval_expr(*s.value, env);
            } else {
                env[s.target] = eval_expr(*s.value, env);
            }
        } else if (s.kind == "if") {
            const auto& branch =
                eval_expr(*s.condition, env) != 0.0 ? s.then_branch : s.else_branch;
            eval_stmts(branch, env);
        } else if (s.kind == "for") {
            long lo = long(eval_expr(*s.range_start, env));
            long hi = long(eval_expr(*s.range_end, env));
            for (long i = lo; i < hi; ++i) {
                env[s.binding] = double(i);
                eval_stmts(s.body, env);
            }
            env.erase(s.binding);
        }
    }
}

// ---------------------------------------------------------------------------
// Covariates: carry / linear interpolation over (time, value) knots
// (dsl/pure.py PureCovariate semantics).
// ---------------------------------------------------------------------------

struct Covariate {
    std::vector<std::pair<double, double>> knots;  // sorted by time
    bool fixed = false;

    double at(double t) const {
        if (knots.empty()) return 0.0;
        if (t <= knots.front().first) return knots.front().second;
        for (size_t i = 0; i + 1 < knots.size(); ++i) {
            double t0 = knots[i].first, v0 = knots[i].second;
            double t1 = knots[i + 1].first, v1 = knots[i + 1].second;
            if (t0 <= t && t < t1) {
                if (fixed || t1 == t0) return v0;
                return v0 + (v1 - v0) * (t - t0) / (t1 - t0);
            }
        }
        return knots.back().second;
    }
};

// ---------------------------------------------------------------------------
// Analytical kernel table (dsl/pure.py _PURE_KERNELS: micro-constant
// compartment matrices; CL variants remap first).
// ---------------------------------------------------------------------------

using Matrix = std::vector<std::vector<double>>;

static Matrix A_1cmt(const std::vector<double>& kp) { return {{-kp[0]}}; }
static Matrix A_1cmt_oral(const std::vector<double>& kp) {
    double ka = kp[0], ke = kp[1];
    return {{-ka, 0.0}, {ka, -ke}};
}
static Matrix A_2cmt(const std::vector<double>& kp) {
    double ke = kp[0], kcp = kp[1], kpc = kp[2];
    return {{-(ke + kcp), kpc}, {kcp, -kpc}};
}
static Matrix A_2cmt_oral(const std::vector<double>& kp) {
    double ke = kp[0], ka = kp[1], kcp = kp[2], kpc = kp[3];
    return {{-ka, 0.0, 0.0}, {ka, -(ke + kcp), kpc}, {0.0, kcp, -kpc}};
}
static Matrix A_3cmt(const std::vector<double>& kp) {
    double k10 = kp[0], k12 = kp[1], k13 = kp[2], k21 = kp[3], k31 = kp[4];
    return {{-(k10 + k12 + k13), k21, k31}, {k12, -k21, 0.0}, {k13, 0.0, -k31}};
}
static Matrix A_3cmt_oral(const std::vector<double>& kp) {
    double ka = kp[0], k10 = kp[1], k12 = kp[2], k13 = kp[3], k21 = kp[4], k31 = kp[5];
    return {{-ka, 0.0, 0.0, 0.0},
            {ka, -(k10 + k12 + k13), k21, k31},
            {0.0, k12, -k21, 0.0},
            {0.0, k13, 0.0, -k31}};
}

struct Kernel {
    std::vector<double> (*remap)(const std::vector<double>&);
    Matrix (*build)(const std::vector<double>&);
};

static std::vector<double> remap_id(const std::vector<double>& kp) { return kp; }

static const std::map<std::string, Kernel>& kernel_table() {
    static const std::map<std::string, Kernel> table = {
        {"one_compartment", {remap_id, A_1cmt}},
        {"one_compartment_with_absorption", {remap_id, A_1cmt_oral}},
        {"one_compartment_cl",
         {+[](const std::vector<double>& kp) { return std::vector<double>{kp[0] / kp[1]}; },
          A_1cmt}},
        {"one_compartment_cl_with_absorption",
         {+[](const std::vector<double>& kp) {
              return std::vector<double>{kp[0], kp[1] / kp[2]};
          },
          A_1cmt_oral}},
        {"two_compartments", {remap_id, A_2cmt}},
        {"two_compartments_with_absorption", {remap_id, A_2cmt_oral}},
        {"two_compartments_cl",
         {+[](const std::vector<double>& kp) {
              return std::vector<double>{kp[0] / kp[2], kp[1] / kp[2], kp[1] / kp[3]};
          },
          A_2cmt}},
        {"two_compartments_cl_with_absorption",
         {+[](const std::vector<double>& kp) {
              return std::vector<double>{kp[1] / kp[3], kp[0], kp[2] / kp[3],
                                         kp[2] / kp[4]};
          },
          A_2cmt_oral}},
        {"three_compartments", {remap_id, A_3cmt}},
        {"three_compartments_with_absorption", {remap_id, A_3cmt_oral}},
        {"three_compartments_cl",
         {+[](const std::vector<double>& kp) {
              return std::vector<double>{kp[0] / kp[3], kp[1] / kp[3], kp[2] / kp[3],
                                         kp[1] / kp[4], kp[2] / kp[5]};
          },
          A_3cmt}},
        {"three_compartments_cl_with_absorption",
         {+[](const std::vector<double>& kp) {
              return std::vector<double>{kp[0], kp[1] / kp[4], kp[2] / kp[4],
                                         kp[3] / kp[4], kp[2] / kp[5], kp[3] / kp[6]};
          },
          A_3cmt_oral}},
    };
    return table;
}

// (P, q) with exp([[A*dt, u*dt], [0, 0]]) = [[P, q], [0, 1]] — the exact
// twin of dsl/pure._expm_affine_py (scaling-and-squaring, 13-term
// Taylor-Horner on the affine block form).
static void expm_affine(const Matrix& A, const std::vector<double>& u, double dt,
                        Matrix& P, std::vector<double>& q) {
    size_t n = A.size();
    Matrix Adt(n, std::vector<double>(n));
    std::vector<double> udt(n);
    for (size_t i = 0; i < n; ++i) {
        for (size_t j = 0; j < n; ++j) Adt[i][j] = A[i][j] * dt;
        udt[i] = u[i] * dt;
    }
    double norm = 0.0;
    for (size_t i = 0; i < n; ++i) {
        double row = std::fabs(udt[i]);
        for (size_t j = 0; j < n; ++j) row += std::fabs(Adt[i][j]);
        norm = std::max(norm, row);
    }
    int s = norm > 1.0 ? std::max(0, int(std::ceil(std::log2(norm)))) : 0;
    double scale = std::ldexp(1.0, -s);
    Matrix As(n, std::vector<double>(n));
    std::vector<double> us(n);
    for (size_t i = 0; i < n; ++i) {
        for (size_t j = 0; j < n; ++j) As[i][j] = Adt[i][j] * scale;
        us[i] = udt[i] * scale;
    }
    auto mm = [n](const Matrix& X, const Matrix& Y) {
        Matrix Z(n, std::vector<double>(n, 0.0));
        for (size_t i = 0; i < n; ++i)
            for (size_t l = 0; l < n; ++l) {
                double x = X[i][l];
                for (size_t j = 0; j < n; ++j) Z[i][j] += x * Y[l][j];
            }
        return Z;
    };
    auto mv = [n](const Matrix& X, const std::vector<double>& y) {
        std::vector<double> z(n, 0.0);
        for (size_t i = 0; i < n; ++i)
            for (size_t l = 0; l < n; ++l) z[i] += X[i][l] * y[l];
        return z;
    };
    P.assign(n, std::vector<double>(n));
    q.assign(n, 0.0);
    for (size_t i = 0; i < n; ++i) {
        for (size_t j = 0; j < n; ++j)
            P[i][j] = (i == j ? 1.0 : 0.0) + As[i][j] / 13.0;
        q[i] = us[i] / 13.0;
    }
    for (int d = 12; d >= 1; --d) {
        Matrix AP = mm(As, P);
        for (size_t i = 0; i < n; ++i)
            for (size_t j = 0; j < n; ++j)
                P[i][j] = (i == j ? 1.0 : 0.0) + AP[i][j] / double(d);
        std::vector<double> Aq = mv(As, q);
        for (size_t i = 0; i < n; ++i) q[i] = (Aq[i] + us[i]) / double(d);
    }
    for (int k = 0; k < s; ++k) {
        std::vector<double> Pq = mv(P, q);
        for (size_t i = 0; i < n; ++i) q[i] = Pq[i] + q[i];
        P = mm(P, P);
    }
}

// ---------------------------------------------------------------------------
// Model (payload["model"]) + simulate (dsl/pure.PureModel semantics).
// ---------------------------------------------------------------------------

struct Model {
    std::string name, kind;
    std::vector<std::string> parameters, covariates, states, outputs, derived;
    std::map<std::string, long> state_arrays;
    std::vector<std::pair<std::string, double>> constants;
    std::string analytical_kernel;
    std::vector<std::pair<std::string, long>> kernel_bindings;  // (source, index)
    long particles = 0;
    std::vector<StmtPtr> derive_s, dynamics_s, outputs_s, init_s, diffusion_s;
    std::vector<std::string> slots;  // expanded state slots

    static Model load(const JsonPtr& payload) {
        auto fmt = payload->get("format");
        if (!fmt || fmt->str != "pharmsol-tpu-pkm")
            runtime_fail("not a pharmsol-tpu artifact");
        const JsonPtr m = payload->get("model");
        Model out;
        out.name = m->get("name")->str;
        out.kind = m->get("kind")->str;
        for (const auto& p : m->get("parameters")->arr) out.parameters.push_back(p->str);
        for (const auto& c : m->get("covariates")->arr)
            out.covariates.push_back(c->arr.at(0)->str);
        for (const auto& s : m->get("states")->arr) out.states.push_back(s->str);
        if (auto sa = m->get("state_arrays"))
            for (const auto& kv : sa->obj) out.state_arrays[kv.first] = long(kv.second->num);
        for (const auto& o : m->get("outputs")->arr) out.outputs.push_back(o->str);
        if (auto cs = m->get("constants"))
            for (const auto& kv : cs->obj) out.constants.emplace_back(kv.first, kv.second->num);
        if (auto d = m->get("derived"); d && !d->is_null())
            for (const auto& x : d->arr) out.derived.push_back(x->str);
        if (auto a = m->get("analytical"); a && !a->is_null()) out.analytical_kernel = a->str;
        if (auto kp = m->get("kernel_plan"); kp && !kp->is_null())
            for (const auto& b : kp->get("bindings")->arr)
                out.kernel_bindings.emplace_back(b->arr.at(0)->str, long(b->arr.at(1)->num));
        if (auto pc = m->get("particles"); pc && !pc->is_null()) out.particles = long(pc->num);
        auto stmts = [&](const char* key, std::vector<StmtPtr>& dst, bool optional) {
            auto v = m->get(key);
            if (!v || v->is_null()) {
                if (!optional) runtime_fail(std::string("missing `") + key + "`");
                return;
            }
            for (const auto& s : v->arr) dst.push_back(Stmt::from_json(s));
        };
        stmts("derive", out.derive_s, false);
        stmts("dynamics", out.dynamics_s, false);
        stmts("outputs_stmts", out.outputs_s, false);
        stmts("init", out.init_s, false);
        stmts("diffusion", out.diffusion_s, true);
        for (const auto& s : out.states) {
            auto it = out.state_arrays.find(s);
            if (it != out.state_arrays.end())
                for (long i = 0; i < it->second; ++i)
                    out.slots.push_back(s + "[" + std::to_string(i) + "]");
            else
                out.slots.push_back(s);
        }
        return out;
    }

    Env base_env(const std::vector<double>& params, double t,
                 const std::map<std::string, Covariate>& cov) const {
        Env env;
        env["t"] = t;
        for (size_t i = 0; i < parameters.size() && i < params.size(); ++i)
            env[parameters[i]] = params[i];
        for (const auto& name : covariates) {
            auto it = cov.find(name);
            env[name] = it != cov.end() ? it->second.at(t) : 0.0;
        }
        for (const auto& kv : constants) env[kv.first] = kv.second;
        eval_stmts(derive_s, env);
        return env;
    }

    std::vector<double> init(const std::vector<double>& params,
                             const std::map<std::string, Covariate>& cov) const {
        Env env = base_env(params, 0.0, cov);
        eval_stmts(init_s, env);
        std::vector<double> x;
        for (const auto& s : slots) {
            auto it = env.find("init:" + s);
            x.push_back(it != env.end() ? it->second : 0.0);
        }
        return x;
    }

    std::vector<double> dynamics(const std::vector<double>& x,
                                 const std::vector<double>& params, double t,
                                 const std::map<std::string, Covariate>& cov) const {
        Env env = base_env(params, t, cov);
        for (size_t i = 0; i < slots.size(); ++i) env[slots[i]] = x[i];
        eval_stmts(dynamics_s, env);
        std::vector<double> dx;
        for (const auto& s : slots) {
            auto it = env.find("dx:" + s);
            dx.push_back(it != env.end() ? it->second : 0.0);
        }
        return dx;
    }

    std::vector<double> out(const std::vector<double>& x,
                            const std::vector<double>& params, double t,
                            const std::map<std::string, Covariate>& cov) const {
        Env env = base_env(params, t, cov);
        for (size_t i = 0; i < slots.size(); ++i) env[slots[i]] = x[i];
        eval_stmts(outputs_s, env);
        std::vector<double> y;
        for (const auto& o : outputs) {
            auto it = env.find("out:" + o);
            y.push_back(it != env.end() ? it->second : 0.0);
        }
        return y;
    }

    // noise targets are keyed per STATE name (runtime parity, pure.py)
    std::vector<double> diffusion(const std::vector<double>& params, double t,
                                  const std::map<std::string, Covariate>& cov) const {
        Env env = base_env(params, t, cov);
        eval_stmts(diffusion_s, env);
        std::vector<double> g;
        for (const auto& s : states) {
            auto it = env.find("noise:" + s);
            g.push_back(it != env.end() ? it->second : 0.0);
        }
        return g;
    }

    std::vector<double> kernel_inputs(const std::vector<double>& params, double t,
                                      const std::map<std::string, Covariate>& cov) const {
        if (kernel_bindings.empty()) runtime_fail("artifact has no analytical kernel plan");
        Env env = base_env(params, t, cov);
        std::vector<double> out;
        for (const auto& b : kernel_bindings) {
            if (b.first == "primary") {
                out.push_back(params.at(size_t(b.second)));
            } else if (b.first == "covariate") {
                const std::string& name = covariates.at(size_t(b.second));
                auto it = cov.find(name);
                out.push_back(it != cov.end() ? it->second.at(t) : 0.0);
            } else {
                out.push_back(env.at(derived.at(size_t(b.second))));
            }
        }
        return out;
    }
};

// Event timeline: pure.py sorts (time, kind, amount, idx) tuples, so at
// equal times "bolus" < "obs" lexicographically, then amount, then idx.
struct Event {
    double t;
    bool is_obs;
    double amount;
    long idx;
    bool operator<(const Event& o) const {
        if (t != o.t) return t < o.t;
        if (is_obs != o.is_obs) return !is_obs;  // "bolus" < "obs"
        if (amount != o.amount) return amount < o.amount;
        return idx < o.idx;
    }
};

struct Scenario {
    std::vector<double> params;
    std::vector<Event> events;
    std::map<std::string, Covariate> cov;
    double dt = 0.01;
    long nparticles = 0;  // 0 -> artifact default -> 100
    uint64_t seed = 0;
};

static Scenario load_scenario(const JsonPtr& j) {
    Scenario sc;
    for (const auto& p : j->get("params")->arr) sc.params.push_back(p->num);
    if (auto b = j->get("boluses"); b && !b->is_null())
        for (const auto& e : b->arr)
            sc.events.push_back(
                {e->arr.at(0)->num, false, e->arr.at(1)->num, long(e->arr.at(2)->num)});
    for (const auto& t : j->get("obs_times")->arr)
        sc.events.push_back({t->num, true, 0.0, 0});
    std::stable_sort(sc.events.begin(), sc.events.end());
    if (auto cs = j->get("covariates"); cs && !cs->is_null())
        for (const auto& kv : cs->obj) {
            Covariate c;
            if (auto f = kv.second->get("fixed"); f && !f->is_null()) c.fixed = f->b;
            for (const auto& k : kv.second->get("knots")->arr)
                c.knots.emplace_back(k->arr.at(0)->num, k->arr.at(1)->num);
            std::stable_sort(c.knots.begin(), c.knots.end());
            sc.cov[kv.first] = c;
        }
    if (auto d = j->get("dt"); d && !d->is_null()) sc.dt = d->num;
    if (auto n = j->get("nparticles"); n && !n->is_null()) sc.nparticles = long(n->num);
    if (auto s = j->get("seed"); s && !s->is_null()) sc.seed = uint64_t(s->num);
    return sc;
}

static std::vector<std::vector<double>> simulate_ode(const Model& m, const Scenario& sc) {
    std::vector<double> x = m.init(sc.params, sc.cov);
    size_t n = x.size();
    double t = 0.0;
    std::vector<std::vector<double>> results;
    auto rk4_to = [&](double t0, double t1, std::vector<double> x) {
        long steps = std::max(1L, long(std::ceil((t1 - t0) / sc.dt)));
        double h = (t1 - t0) / double(steps);
        for (long i = 0; i < steps; ++i) {
            double ti = t0 + double(i) * h;
            std::vector<double> k1 = m.dynamics(x, sc.params, ti, sc.cov);
            std::vector<double> x2(n), x3(n), x4(n);
            for (size_t s = 0; s < n; ++s) x2[s] = x[s] + 0.5 * h * k1[s];
            std::vector<double> k2 = m.dynamics(x2, sc.params, ti + 0.5 * h, sc.cov);
            for (size_t s = 0; s < n; ++s) x3[s] = x[s] + 0.5 * h * k2[s];
            std::vector<double> k3 = m.dynamics(x3, sc.params, ti + 0.5 * h, sc.cov);
            for (size_t s = 0; s < n; ++s) x4[s] = x[s] + h * k3[s];
            std::vector<double> k4 = m.dynamics(x4, sc.params, ti + h, sc.cov);
            for (size_t s = 0; s < n; ++s)
                x[s] += h / 6.0 * (k1[s] + 2.0 * k2[s] + 2.0 * k3[s] + k4[s]);
        }
        return x;
    };
    for (const Event& e : sc.events) {
        if (e.t > t) {
            x = rk4_to(t, e.t, x);
            t = e.t;
        }
        if (e.is_obs)
            results.push_back(m.out(x, sc.params, t, sc.cov));
        else
            x.at(size_t(e.idx)) += e.amount;
    }
    return results;
}

static std::vector<std::vector<double>> simulate_analytical(const Model& m,
                                                            const Scenario& sc) {
    auto it = kernel_table().find(m.analytical_kernel);
    if (it == kernel_table().end())
        runtime_fail("unknown analytical kernel `" + m.analytical_kernel + "`");
    const Kernel& k = it->second;
    std::vector<double> x = m.init(sc.params, sc.cov);
    size_t n = x.size();
    double t = 0.0;
    std::vector<std::vector<double>> results;
    for (const Event& e : sc.events) {
        if (e.t > t) {
            // kernel inputs at the segment END (engine parity:
            // dsl/runtime.make_analytical_propagate derives at t0+dt)
            std::vector<double> kp = k.remap(m.kernel_inputs(sc.params, e.t, sc.cov));
            Matrix A = k.build(kp);
            Matrix P;
            std::vector<double> q;
            expm_affine(A, std::vector<double>(n, 0.0), e.t - t, P, q);
            std::vector<double> xn(n);
            for (size_t i = 0; i < n; ++i) {
                double acc = q[i];
                for (size_t j = 0; j < n; ++j) acc += P[i][j] * x[j];
                xn[i] = acc;
            }
            x = xn;
            t = e.t;
        }
        if (e.is_obs)
            results.push_back(m.out(x, sc.params, t, sc.cov));
        else
            x.at(size_t(e.idx)) += e.amount;
    }
    return results;
}

static std::vector<std::vector<double>> simulate_sde(const Model& m, const Scenario& sc) {
    long P = sc.nparticles > 0 ? sc.nparticles : (m.particles > 0 ? m.particles : 100);
    std::mt19937_64 rng(sc.seed);
    std::normal_distribution<double> gauss(0.0, 1.0);
    std::vector<double> x0 = m.init(sc.params, sc.cov);
    size_t n = x0.size();
    std::vector<std::vector<double>> cloud(size_t(P), x0);
    double t = 0.0;
    std::vector<std::vector<double>> results;
    auto em_to = [&](double t0, double t1) {
        long steps = std::max(1L, long(std::ceil((t1 - t0) / sc.dt)));
        double h = (t1 - t0) / double(steps);
        double sq = std::sqrt(h);
        for (long i = 0; i < steps; ++i) {
            double ti = t0 + double(i) * h;
            std::vector<double> g = m.diffusion(sc.params, ti, sc.cov);
            for (auto& part : cloud) {
                std::vector<double> d = m.dynamics(part, sc.params, ti, sc.cov);
                for (size_t s = 0; s < n; ++s)
                    part[s] += d[s] * h + g[s] * gauss(rng) * sq;
            }
        }
    };
    for (const Event& e : sc.events) {
        if (e.t > t) {
            em_to(t, e.t);
            t = e.t;
        }
        if (e.is_obs) {
            std::vector<double> mean(m.outputs.size(), 0.0);
            for (const auto& part : cloud) {
                std::vector<double> y = m.out(part, sc.params, t, sc.cov);
                for (size_t o = 0; o < mean.size(); ++o) mean[o] += y[o];
            }
            for (double& v : mean) v /= double(P);
            results.push_back(mean);
        } else {
            for (auto& part : cloud) part.at(size_t(e.idx)) += e.amount;
        }
    }
    return results;
}

static std::string read_file(const char* path) {
    std::ifstream f(path, std::ios::binary);
    if (!f) runtime_fail(std::string("cannot open `") + path + "`");
    std::ostringstream ss;
    ss << f.rdbuf();
    return ss.str();
}

int main(int argc, char** argv) {
    if (argc == 2 && std::strcmp(argv[1], "--version") == 0) {
        std::printf("pkm_host 1 (pharmsol-tpu portable host)\n");
        return 0;
    }
    if (argc != 3) {
        std::fprintf(stderr, "usage: pkm_host <model.pkm> <scenario.json>\n");
        return 2;
    }
    try {
        JsonPtr payload = JsonParser(read_file(argv[1])).parse();
        JsonPtr scj = JsonParser(read_file(argv[2])).parse();
        Model model = Model::load(payload);
        Scenario sc = load_scenario(scj);
        std::vector<std::vector<double>> results;
        if (model.kind == "analytical")
            results = simulate_analytical(model, sc);
        else if (model.kind == "sde")
            results = simulate_sde(model, sc);
        else if (model.kind == "ode")
            results = simulate_ode(model, sc);
        else
            runtime_fail("unsupported model kind `" + model.kind + "`");
        std::printf("[");
        for (size_t r = 0; r < results.size(); ++r) {
            std::printf("%s[", r ? "," : "");
            for (size_t o = 0; o < results[r].size(); ++o)
                std::printf("%s%.17g", o ? "," : "", results[r][o]);
            std::printf("]");
        }
        std::printf("]\n");
        return 0;
    } catch (const std::exception& e) {
        std::fprintf(stderr, "%s\n", e.what());
        return 1;
    }
}
