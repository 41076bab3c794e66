// Native CPLEX LP-format parser.
//
// Mirrors the grammar of the Python parser in io/lp_parse.py (which itself
// mirrors the reference parser, reference: lib/src/parser.cpp): sections
// maximize/minimize, subject-to, bounds, binary, general, end; separators
// < = > : - + [ ] * ^ always split tokens; '\\' comments to end of line;
// quadratic objective blocks [ k a * b + x ^ 2 ] / 2.
//
// Exposed as a C ABI for ctypes: parse into flat arrays, query counts and
// copy results out, then free. One parse handle per call, no global state.
//
// Build (baryonyx_torch/native/build.py does it at first use, into
// build/native/ at the root of the checkout):
//   g++ -O2 -std=c++17 -shared -fPIC lp_parser.cpp -o liblpparse.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Token {
    const char* s;
    int len;
};

inline bool is_sep(char c) {
    switch (c) {
    case '<': case '=': case '>': case ':': case '-': case '+':
    case '[': case ']': case '*': case '^':
        return true;
    default:
        return false;
    }
}

inline bool is_name_char(char c) {
    if (std::isalnum(static_cast<unsigned char>(c)))
        return true;
    switch (c) {
    case '!': case '"': case '#': case '$': case '%': case '&':
    case '(': case ')': case ',': case '.': case ';': case '?':
    case '@': case '_': case '{': case '}': case '~':
        return true;
    default:
        return false;
    }
}

inline bool is_num_char(char c) {
    return std::isdigit(static_cast<unsigned char>(c)) || c == '.' ||
           c == 'e' || c == 'E' || c == '-' || c == '+';
}

struct Tokenizer {
    std::vector<Token> tokens;

    void run(const char* text, size_t len) {
        size_t i = 0;
        while (i < len) {
            char c = text[i];
            if (c == '\\') {  // comment to end of line
                while (i < len && text[i] != '\n') ++i;
                continue;
            }
            if (std::isspace(static_cast<unsigned char>(c))) {
                ++i;
                continue;
            }
            if (is_sep(c)) {
                tokens.push_back({text + i, 1});
                ++i;
                continue;
            }
            size_t start = i++;
            if (std::isdigit(static_cast<unsigned char>(c)) || c == '.') {
                while (i < len && !is_sep(text[i]) && is_num_char(text[i]) &&
                       !std::isspace(static_cast<unsigned char>(text[i])))
                    ++i;
            } else {
                while (i < len && !is_sep(text[i]) &&
                       !std::isspace(static_cast<unsigned char>(text[i])) &&
                       text[i] != '\\')
                    ++i;
            }
            tokens.push_back({text + start, static_cast<int>(i - start)});
        }
    }
};

struct Parsed {
    // variables
    std::vector<std::string> var_names;
    std::vector<int32_t> var_min, var_max, var_type;  // type: 0 real 1 bin 2 gen
    // objective
    std::vector<int32_t> obj_idx;
    std::vector<double> obj_coef;
    std::vector<int32_t> qa, qb;
    std::vector<double> qcoef;
    double obj_constant = 0.0;
    int32_t maximize = 1;
    // constraints (flattened)
    std::vector<int32_t> cst_op;  // 0 equal 1 greater 2 less
    std::vector<int32_t> cst_rhs;
    std::vector<int32_t> cst_start;  // element offsets, size ncst+1
    std::vector<std::string> cst_labels;
    std::vector<int32_t> el_var;
    std::vector<int32_t> el_coef;
    std::string error;
};

constexpr int32_t INT_INF = 2147483647;

struct Parser {
    const std::vector<Token>& t;
    size_t pos = 0;
    Parsed& out;
    std::unordered_map<std::string, int32_t> var_index;

    Parser(const std::vector<Token>& t_, Parsed& out_) : t(t_), out(out_) {}

    std::string tok(size_t k = 0) const {
        size_t i = pos + k;
        if (i >= t.size())
            return std::string();
        return std::string(t[i].s, t[i].len);
    }

    static std::string lower(std::string s) {
        for (auto& c : s)
            c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
        return s;
    }

    bool is_keyword(const std::string& raw) const {
        static const char* kws[] = {"binary", "binaries", "bin",      "bound",
                                    "bounds", "general",  "generals", "gen",
                                    "end",    "st",       "subject",  "sush",
                                    "s.t.",   "st."};
        auto s = lower(raw);
        for (auto* k : kws)
            if (s == k)
                return true;
        return false;
    }

    static bool parse_double(const std::string& s, double* v) {
        if (s.size() >= 3) {
            auto l = lower(s);
            if (l == "inf" || l == "infinity") {
                *v = 1e300;
                return true;
            }
        }
        char* endp = nullptr;
        double r = std::strtod(s.c_str(), &endp);
        if (endp == s.c_str())
            return false;
        *v = r;
        return true;
    }

    // returns consumed count; 0 tokens consumed means implicit factor 1
    int read_real(double* v) {
        auto t1 = tok(0);
        if (t1 == "-") {
            double d;
            if (parse_double(tok(1), &d)) {
                *v = -d;
                return 2;
            }
            *v = -1.0;
            return 1;
        }
        if (t1 == "+") {
            double d;
            if (parse_double(tok(1), &d)) {
                *v = d;
                return 2;
            }
            *v = 1.0;
            return 1;
        }
        double d;
        if (parse_double(t1, &d)) {
            *v = d;
            return 1;
        }
        *v = 1.0;
        return 0;
    }

    static bool starts_with_name(const std::string& s) {
        return !s.empty() && is_name_char(s[0]);
    }

    static bool is_full_name(const std::string& s) {
        if (s.empty())
            return false;
        for (char c : s)
            if (!is_name_char(c))
                return false;
        return true;
    }

    int32_t get_or_assign(const std::string& name) {
        auto it = var_index.find(name);
        if (it != var_index.end())
            return it->second;
        int32_t id = static_cast<int32_t>(out.var_names.size());
        var_index.emplace(name, id);
        out.var_names.push_back(name);
        out.var_min.push_back(0);
        out.var_max.push_back(INT_INF);
        out.var_type.push_back(0);
        return id;
    }

    // read [sign] [number] [name]; returns consumed, name empty = constant
    int read_element(double* factor, std::string* name) {
        int read = read_real(factor);
        auto nx = tok(read);
        if (!is_keyword(nx) && is_full_name(nx)) {
            *name = nx;
            return read + 1;
        }
        name->clear();
        return read;
    }

    // op codes: 0 equal, 1 greater, 2 less; returns consumed or 0
    int read_operator(int* op, size_t offset = 0) {
        auto t1 = tok(offset), t2 = tok(offset + 1);
        if (t1 == "<") {
            *op = 2;
            return t2 == "=" ? 2 : 1;
        }
        if (t1 == ">") {
            *op = 1;
            return t2 == "=" ? 2 : 1;
        }
        if (t1 == "=") {
            if (t2 == "<") {
                *op = 2;
                return 2;
            }
            if (t2 == ">") {
                *op = 1;
                return 2;
            }
            if (t2 == "=") {
                *op = 0;
                return 2;
            }
            *op = 0;
            return 1;
        }
        return 0;
    }

    bool fail(const std::string& msg) {
        out.error = msg + " near '" + tok(0) + " " + tok(1) + " " + tok(2) + "'";
        return false;
    }

    bool parse() {
        auto head = lower(tok());
        if (head == "maximize" || head == "maximum" || head == "max")
            out.maximize = 1;
        else if (head == "minimize" || head == "minimum" || head == "min")
            out.maximize = 0;
        else
            return fail("bad objective type");
        ++pos;
        if (!is_keyword(tok()) && tok(1) == ":")
            pos += 2;

        if (!parse_objective())
            return false;
        if (!parse_constraints())
            return false;
        if (!parse_bounds())
            return false;
        if (!parse_var_section({"binary", "binaries", "bin"}, 1))
            return false;
        if (!parse_var_section({"general", "generals", "gen"}, 2))
            return false;
        if (lower(tok()) != "end")
            return fail("missing end");
        pos += tok(1) == ":" ? 2 : 1;
        if (pos < t.size())
            return fail("trailing tokens after end");
        return true;
    }

    void add_objective(double factor, const std::string& name) {
        if (name.empty()) {
            out.obj_constant += factor;
            return;
        }
        int32_t id = get_or_assign(name);
        for (size_t i = 0; i < out.obj_idx.size(); ++i)
            if (out.obj_idx[i] == id) {
                out.obj_coef[i] += factor;
                return;
            }
        out.obj_idx.push_back(id);
        out.obj_coef.push_back(factor);
    }

    void add_quad(double factor, int32_t a, int32_t b) {
        for (size_t i = 0; i < out.qa.size(); ++i)
            if ((out.qa[i] == a && out.qb[i] == b) ||
                (out.qa[i] == b && out.qb[i] == a)) {
                out.qcoef[i] += factor;
                return;
            }
        out.qa.push_back(a);
        out.qb.push_back(b);
        out.qcoef.push_back(factor);
    }

    bool parse_quadratic(double sign) {
        if (tok() != "[")
            return fail("bad quadratic block");
        ++pos;
        while (pos < t.size() && tok() != "]") {
            double v;
            int read = read_real(&v);
            auto name = tok(read);
            if (is_keyword(name) || !is_full_name(name))
                return fail("bad quadratic element");
            pos += read + 1;
            if (tok() == "*") {
                auto name2 = tok(1);
                if (!is_full_name(name2))
                    return fail("bad quadratic pair");
                add_quad(v * sign / 2.0, get_or_assign(name),
                         get_or_assign(name2));
                pos += 2;
            } else if (tok() == "^" || tok() == "^2") {
                if (tok() == "^" && tok(1) == "2")
                    pos += 2;
                else
                    pos += 1;
                int32_t id = get_or_assign(name);
                add_quad(v * sign / 2.0, id, id);
            }
        }
        ++pos;  // ']'
        if (tok() == "/" && tok(1) == "2")
            pos += 2;
        else if (tok() == "/2")
            pos += 1;
        else
            return fail("quadratic block missing /2");
        return true;
    }

    bool parse_objective() {
        while (pos < t.size() && !is_keyword(tok())) {
            auto t1 = tok(), t2 = tok(1);
            if (t1 == "[" || ((t1 == "+" || t1 == "-") && t2 == "[")) {
                double sign = 1.0;
                if (t1 == "-") {
                    sign = -1.0;
                    ++pos;
                } else if (t1 == "+")
                    ++pos;
                if (!parse_quadratic(sign))
                    return false;
                continue;
            }
            double factor;
            std::string name;
            int read = read_element(&factor, &name);
            if (read == 0 && name.empty())
                return fail("bad objective");
            add_objective(factor, name);
            pos += read;
        }
        return true;
    }

    int read_subject_to() {
        auto t1 = lower(tok()), t2 = tok(1), t3 = tok(2);
        if (t1 == "st" || t1 == "st." || t1 == "s.t" || t1 == "s.t.")
            return t2 == ":" ? 2 : 1;
        if (t1 == "subject" && lower(t2) == "to")
            return t3 == ":" ? 3 : 2;
        if (t1 == "sush" && lower(t2) == "that")
            return t3 == ":" ? 3 : 2;
        return 0;
    }

    bool parse_constraints() {
        int read = read_subject_to();
        if (!read)
            return true;
        pos += read;
        while (pos < t.size() && !is_keyword(tok())) {
            std::string label;
            if (starts_with_name(tok()) && tok(1) == ":") {
                label = tok();
                pos += 2;
            }
            size_t el_begin = out.el_var.size();
            // first element
            while (true) {
                auto cur = tok();
                if (cur.empty())
                    return fail("unterminated constraint");
                if (cur[0] == '<' || cur[0] == '>' || cur[0] == '=')
                    break;
                double factor;
                std::string name;
                int r = read_element(&factor, &name);
                if (name.empty())
                    return fail("bad constraint element");
                int32_t id = get_or_assign(name);
                bool merged = false;
                for (size_t i = el_begin; i < out.el_var.size(); ++i)
                    if (out.el_var[i] == id) {
                        out.el_coef[i] += static_cast<int32_t>(factor);
                        merged = true;
                        break;
                    }
                if (!merged) {
                    out.el_var.push_back(id);
                    out.el_coef.push_back(static_cast<int32_t>(factor));
                }
                pos += r;
            }
            int op;
            int opread = read_operator(&op);
            if (!opread)
                return fail("bad constraint operator");
            pos += opread;
            double rhs;
            int vr = read_real(&rhs);
            if (vr == 0)
                return fail("bad constraint value");
            pos += vr;
            out.cst_op.push_back(op);
            out.cst_rhs.push_back(static_cast<int32_t>(rhs));
            out.cst_labels.push_back(label);
            out.cst_start.push_back(static_cast<int32_t>(el_begin));
        }
        return true;
    }

    int read_right_bound(size_t offset, double* v) {
        int op;
        int opread = read_operator(&op, offset);
        if (!opread)
            return 0;
        size_t i = offset + opread;
        double neg = 1.0;
        auto s = tok(i);
        if (s == "+" || s == "-") {
            if (s == "-")
                neg = -1.0;
            ++i;
        }
        double d;
        if (!parse_double(tok(i), &d))
            return 0;
        *v = neg * d;
        return static_cast<int>(i + 1 - offset);
    }

    bool set_bound(const std::string& name, double lo, double hi) {
        auto it = var_index.find(name);
        if (it == var_index.end())
            return fail("bound on unknown variable " + name);
        out.var_min[it->second] =
            lo <= -1e299 ? -2147483648LL : static_cast<int32_t>(lo);
        out.var_max[it->second] =
            hi >= 1e299 ? INT_INF : static_cast<int32_t>(hi);
        return true;
    }

    bool parse_bounds() {
        auto t1 = lower(tok());
        if (t1 != "bounds" && t1 != "bound")
            return true;
        pos += tok(1) == ":" ? 2 : 1;
        while (pos < t.size() && !is_keyword(tok())) {
            auto cur = tok();
            // number-vs-name precedence matches the reference tokenizer
            // (parser.cpp:908-938): a token starting with a digit, '.',
            // sign, or exponent char is a number — digit-only tokens are
            // also syntactically valid names, and the reference reads
            // them as the left bound ("0 <= x <= 1")
            bool numeric =
                !cur.empty() &&
                (std::isdigit(static_cast<unsigned char>(cur[0])) ||
                 cur[0] == '.' || cur[0] == 'e' || cur[0] == 'E' ||
                 cur[0] == '+' || cur[0] == '-');
            if (numeric) {
                double neg = 1.0;
                size_t i = 0;
                if (cur == "+" || cur == "-") {
                    if (cur == "-")
                        neg = -1.0;
                    i = 1;
                }
                double left;
                if (!parse_double(tok(i), &left))
                    return fail("bad bound");
                left *= neg;
                int op;
                int opread = read_operator(&op, i + 1);
                if (!opread)
                    return fail("bad bound operator");
                i += 1 + opread;
                auto name = tok(i);
                if (!is_full_name(name))
                    return fail("bad bound name");
                ++i;
                double right;
                int rr = read_right_bound(i, &right);
                if (!rr) {
                    if (!set_bound(name, left, 1e300))
                        return false;
                    pos += i;
                } else {
                    if (left > right)
                        return fail("bound min > max");
                    if (!set_bound(name, left, right))
                        return false;
                    pos += i + rr;
                }
            } else if (starts_with_name(cur)) {
                double right;
                int rr = read_right_bound(1, &right);
                if (!rr) {
                    if (!set_bound(cur, -1e300, 1e300))
                        return false;
                    pos += 1;
                } else {
                    // reference quirk: the operator is ignored, value is
                    // always the upper bound with min = 0
                    if (!set_bound(cur, 0.0, right))
                        return false;
                    pos += 1 + rr;
                }
            } else {
                return fail("bad bound line");
            }
        }
        return true;
    }

    bool parse_var_section(std::vector<std::string> names, int32_t type) {
        auto t1 = lower(tok());
        bool match = false;
        for (auto& nm : names)
            if (t1 == nm)
                match = true;
        if (!match)
            return true;
        pos += tok(1) == ":" ? 2 : 1;
        while (pos < t.size() && !is_keyword(tok())) {
            auto it = var_index.find(tok());
            if (it == var_index.end())
                return fail("unknown variable in section: " + tok());
            out.var_type[it->second] = type;
            if (type == 1) {
                out.var_min[it->second] = 0;
                out.var_max[it->second] = 1;
            }
            ++pos;
        }
        return true;
    }
};

}  // namespace

extern "C" {

struct LpHandle {
    Parsed p;
    std::string names_blob;        // '\n'-joined var names
    std::string labels_blob;       // '\n'-joined constraint labels
};

static LpHandle* lp_parse_text(const char* text, size_t len) {
    auto* h = new LpHandle();
    Tokenizer tz;
    tz.run(text, len);
    Parser ps(tz.tokens, h->p);
    if (!ps.parse()) {
        if (h->p.error.empty())
            h->p.error = "parse error";
        return h;  // caller must check lp_error
    }
    h->p.cst_start.push_back(static_cast<int32_t>(h->p.el_var.size()));
    for (size_t i = 0; i < h->p.var_names.size(); ++i) {
        h->names_blob += h->p.var_names[i];
        h->names_blob += '\n';
    }
    for (size_t i = 0; i < h->p.cst_labels.size(); ++i) {
        h->labels_blob += h->p.cst_labels[i];
        h->labels_blob += '\n';
    }
    return h;
}

LpHandle* lp_parse_file(const char* path) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh)
        return nullptr;
    std::fseek(fh, 0, SEEK_END);
    long size = std::ftell(fh);
    std::fseek(fh, 0, SEEK_SET);
    std::string text(static_cast<size_t>(size), '\0');
    size_t got = std::fread(text.data(), 1, static_cast<size_t>(size), fh);
    std::fclose(fh);
    text.resize(got);
    return lp_parse_text(text.data(), text.size());
}

// in-memory entry point (used by parse_lp on large strings)
LpHandle* lp_parse_buffer(const char* text, size_t len) {
    return lp_parse_text(text, len);
}

const char* lp_error(LpHandle* h) {
    return h->p.error.empty() ? nullptr : h->p.error.c_str();
}

int32_t lp_maximize(LpHandle* h) { return h->p.maximize; }
double lp_obj_constant(LpHandle* h) { return h->p.obj_constant; }
int32_t lp_n_vars(LpHandle* h) { return (int32_t)h->p.var_names.size(); }
int32_t lp_n_obj(LpHandle* h) { return (int32_t)h->p.obj_idx.size(); }
int32_t lp_n_quad(LpHandle* h) { return (int32_t)h->p.qa.size(); }
int32_t lp_n_cst(LpHandle* h) { return (int32_t)h->p.cst_op.size(); }
int32_t lp_n_elements(LpHandle* h) { return (int32_t)h->p.el_var.size(); }
const char* lp_var_names(LpHandle* h) { return h->names_blob.c_str(); }
const char* lp_cst_labels(LpHandle* h) { return h->labels_blob.c_str(); }
const int32_t* lp_var_min(LpHandle* h) { return h->p.var_min.data(); }
const int32_t* lp_var_max(LpHandle* h) { return h->p.var_max.data(); }
const int32_t* lp_var_type(LpHandle* h) { return h->p.var_type.data(); }
const int32_t* lp_obj_idx(LpHandle* h) { return h->p.obj_idx.data(); }
const double* lp_obj_coef(LpHandle* h) { return h->p.obj_coef.data(); }
const int32_t* lp_qa(LpHandle* h) { return h->p.qa.data(); }
const int32_t* lp_qb(LpHandle* h) { return h->p.qb.data(); }
const double* lp_qcoef(LpHandle* h) { return h->p.qcoef.data(); }
const int32_t* lp_cst_op(LpHandle* h) { return h->p.cst_op.data(); }
const int32_t* lp_cst_rhs(LpHandle* h) { return h->p.cst_rhs.data(); }
const int32_t* lp_cst_start(LpHandle* h) { return h->p.cst_start.data(); }
const int32_t* lp_el_var(LpHandle* h) { return h->p.el_var.data(); }
const int32_t* lp_el_coef(LpHandle* h) { return h->p.el_coef.data(); }

void lp_free(LpHandle* h) { delete h; }

}  // extern "C"
